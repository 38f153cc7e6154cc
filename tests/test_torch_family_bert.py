"""BERT-layout retrievers trained by the port from a BERT init (tiny:
2 layers x 32, ``type_vocab_size`` 2, vocab 1,024; see
``tests/torch_family_util.py`` for the world) against ``dhr_tpu`` on the
CPU:

- the untied DHR chain on TASB batches: the port's ``train
  --untie-encoder --query-cluster-path``, then both packages' ``encode``
  -> ``index`` -> ``search`` (theta 0; 0.3 with rerank) -> ``eval`` at
  ``check_chains``' bars, and the first batch's queries against
  ``dhr_tpu``'s ``TASBSampler``;
- the packed ColBERT chain (``train --model colbert --pack-passages``),
  then both packages' ``encode --model colbert`` -> ``colbert-score
  --full-ranking``;
- pins of two faults of ``dhr_tpu`` that the port repairs: an export
  trained from a BERT init is written under ``distilbert.*`` keys without
  token types, so it cannot be encoded; an untied export
  (``query_model/`` + ``passage_model/``) cannot be loaded at all;
- what each package does with DPR's towers as ``convert_dpr_checkpoint``
  writes them (bare ``BertModel`` keys).

``dhr_tpu``'s CLI cannot load an untied export, so its side of the untied
chain reads the towers as upstream does (:func:`reference_untied_loader`):
each through ``convert_hf_mlm_to_params`` from its sub-directory, the
sidecars' q and p halves from the export's root.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import pytest
import torch

from dhr_tpu.cli.main import _load_init_params as jax_load_init_params
from dhr_tpu.cli.main import main as jax_main
from dhr_tpu_torch.cli.main import main as port_main
from dhr_tpu_torch.models import BiEncoder, load_flax_params
from dhr_tpu_torch.models import random_flax_params
from dhr_tpu_torch.models.flax_params import flax_to_state_dict
from dhr_tpu_torch.models.retrievers import RetrieverConfig
from dhr_tpu_torch.models.transformer import EncoderConfig
from dhr_tpu_torch.train.checkpoint import export_hf_checkpoint, hf_config_of
from tests import torch_family_util as fu
from tests.test_torch_encode import assert_f16_within_one_ulp

BERT = EncoderConfig.tiny(type_vocab_size=2, dtype=torch.float32)
TOKEN_TYPES = "bert.embeddings.token_type_embeddings.weight"
STEPS = 3
# the model flags of each layout a BERT init is trained into
LAYOUTS = {
    "dhr_tied": ["--model", "dhr", "--dlr-out-dim", str(fu.OUT)],
    "dhr_untied": fu.VARIANTS["dhr_untied"],
    "dense": fu.VARIANTS["dense_cls"],
    "colbert": ["--model", "colbert"],
}
N_CLUSTERS = 4  # of 4 train-group indices each


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bert_init(root) -> str:
    """A random tiny BERT DHR tree (seed 11: an MLM head, the pooler and
    term-weight sidecars) exported as a ``bert`` HF directory."""
    cfg = RetrieverConfig(model_type="dhr", add_pooler=True,
                          projection_dim=16, dlr_out_dim=fu.OUT, encoder=BERT)
    model = load_flax_params(BiEncoder(cfg), random_flax_params(
        cfg, torch.Generator().manual_seed(11)))
    out = str(root / "bert_init")
    export_hf_checkpoint(out, model, cfg, arch="bert")
    return out


def write_clusters(root) -> str:
    """TASB clusters over the world's train groups, from a numpy seed."""
    perm = np.random.default_rng(29).permutation(fu.N_GROUPS)
    path = str(root / "clusters.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps({"qidx": c.tolist()}) + "\n"
                     for c in perm.reshape(N_CLUSTERS, -1))
    return path


def train(root, paths, init, layout, extra=(), steps=STEPS):
    """The port's ``train`` verb (f32, CPU) from ``init``; returns the
    output directory.  Asserts the per-step losses are finite."""
    out = root / f"train_{layout}"
    port_main(["train", *LAYOUTS[layout], *fu.COMMON, "--model-name-or-path",
               init, "--train-path", paths["train"], "--corpus-path",
               paths["corpus"], "--output-dir", str(out), "--batch-size",
               "4", "--train-n-passages", "3", "--p-max-len",
               str(fu.P_LEN), "--q-max-len", str(fu.Q_LEN), "--max-steps",
               str(steps), "--warmup-steps", "1", "--log-steps", "1",
               "--metrics-path", str(out) + ".jsonl", "--device", "cpu",
               *extra])
    with open(str(out) + ".jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == steps and np.isfinite(losses).all(), losses
    return out


def trained_state(out, steps=STEPS) -> dict:
    """The trained model's state dict (the run's last checkpoint)."""
    return torch.load(out / f"step_{steps:08d}" / "state.pt",
                      weights_only=True)["model"]


def _args(argv):
    """``dhr_tpu``'s parsed ``encode`` arguments for model flags."""
    from dhr_tpu.cli.main import build_parser

    return build_parser().parse_args(["encode", *argv, "--input", "-",
                                      "--output", "-"])


def reference_params(root, jcfg, untied):
    """``dhr_tpu``'s parameter tree of the export at ``root``, loaded as
    upstream does: each tower's backbone through
    ``convert_hf_mlm_to_params`` from its directory (``query_model/`` and
    ``passage_model/`` when untied), the sidecars' q and p halves from the
    root."""
    from dhr_tpu.models.hf_io import (
        convert_hf_mlm_to_params, load_hf_state_dict, load_sidecar_head)

    _, params = jax_load_init_params(argparse.Namespace(
        model_name_or_path=None), jcfg)  # the tree's layout, random
    sides = {"encoder_q": "query_model", "encoder_p": "passage_model"}
    for side in ["encoder_q"] + (["encoder_p"] if untied else []):
        d = os.path.join(root, sides[side]) if untied else root
        backbone = convert_hf_mlm_to_params(load_hf_state_dict(d),
                                            jcfg.encoder)
        params[side]["backbone"] = (backbone if "encoder" in
                                    params[side]["backbone"]
                                    else backbone["encoder"])
        for name, key in (("pooler", "pooler"),
                          ("TermWeightTrans", "term_weight")):
            head = load_sidecar_head(root, name)
            if head is not None and key in params[side]:
                half = head["p"] if side == "encoder_p" else head["q"]
                params[side][key] = {"linear": half}
    return params


@pytest.fixture
def reference_untied_loader(monkeypatch):
    """Let ``dhr_tpu``'s verbs load an untied export (its own loader
    cannot: the R2 pin below) through :func:`reference_params`."""
    import dhr_tpu.cli.main as jcli
    from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder

    cfg_of = jcli._model_cfg_from_args

    def model_cfg(args):
        sub = argparse.Namespace(**vars(args))
        sub.model_name_or_path = os.path.join(args.model_name_or_path,
                                              "query_model")
        return cfg_of(sub)

    def load(args, cfg):
        return JaxBiEncoder(cfg), reference_params(args.model_name_or_path,
                                                   cfg, untied=True)

    monkeypatch.setattr(jcli, "_model_cfg_from_args", model_cfg)
    monkeypatch.setattr(jcli, "_load_init_params", load)


def export_keys(export, untied):
    from dhr_tpu_torch.models.hf_io import load_hf_state_dict

    dirs = ([os.path.join(export, d) for d in ("query_model",
                                                "passage_model")]
            if untied else [export])
    return [set(load_hf_state_dict(d)) for d in dirs]


# ------------------------------------------------------------- chains --


def test_untied_tasb_dhr_chain_matches_reference(tmp_path, capsys,
                                                 monkeypatch,
                                                 reference_untied_loader):
    from dhr_tpu.data.sampling import TASBSampler as JaxTASBSampler
    from dhr_tpu_torch.data.loader import TrainLoader

    paths = fu.write_world(tmp_path)
    clusters = write_clusters(tmp_path)
    batches = []
    collate = TrainLoader._collate

    def spy(self, items, epoch, rng):
        batches.append(list(items))
        return collate(self, items, epoch, rng)

    monkeypatch.setattr(TrainLoader, "_collate", spy)
    out = train(tmp_path, paths, bert_init(tmp_path), "dhr_untied",
                ["--query-cluster-path", clusters, "--seed", "7"])
    with open(clusters) as f:
        want = JaxTASBSampler([json.loads(line) for line in f],
                              seed=7).batch_indices(0, 4)
    assert batches[0] == want
    export = str(out / "export")
    keys_q, keys_p = export_keys(export, untied=True)
    assert TOKEN_TYPES in keys_q and TOKEN_TYPES in keys_p
    state = trained_state(out)
    assert not torch.equal(
        state["encoder_q.backbone.encoder.layers.0.ffn_in.weight"],
        state["encoder_p.backbone.encoder.layers.0.ffn_in.weight"])
    metrics = fu.check_chains(
        tmp_path, paths, "dhr_untied", export,
        {"theta0": ["--theta", "0"],
         "theta0.3_rerank": ["--theta", "0.3", "--rerank"]}, capsys)
    assert set(metrics) == {"theta0", "theta0.3_rerank"}


def test_packed_colbert_chain_matches_reference(tmp_path):
    paths = fu.write_world(tmp_path)
    out = train(tmp_path, paths, bert_init(tmp_path), "colbert",
                ["--pack-passages"])
    export = str(out / "export")
    (keys,) = export_keys(export, untied=False)
    assert TOKEN_TYPES in keys and not any(k.startswith("cls.")
                                           for k in keys)  # encoder-only
    model = ["--model", "colbert", "--add-pooler", "--projection-dim", "16",
             *fu.SPECIALS, "--model-name-or-path", export, "--p-max-len",
             str(fu.P_LEN), "--q-max-len", str(fu.Q_LEN), "--batch-size",
             "8"]
    for who, main, dev in (("ref", jax_main, []),
                           ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        main(["encode", *model, "--input", paths["corpus"], "--output",
              str(d / "p_reps"), *dev])
        main(["encode", *model, "--input", paths["queries"], "--output",
              str(d / "q_reps"), "--encode-is-qry", *dev])
    for name in ("p_reps", "q_reps"):
        with np.load(tmp_path / "ref" / f"{name}.npz") as w, \
                np.load(tmp_path / "port" / f"{name}.npz") as g:
            assert_f16_within_one_ulp(g["token"], w["token"])
        with open(tmp_path / "ref" / f"{name}.ids.json") as w, \
                open(tmp_path / "port" / f"{name}.ids.json") as g:
            assert json.load(g) == json.load(w)

    def score(main, reps, out_path, dev):
        d = tmp_path / reps
        main(["colbert-score", "--query-reps", str(d / "q_reps"),
              "--passage-reps", str(d / "p_reps"), "--full-ranking",
              "--topk", "20", "--output", out_path, *dev])

    score(jax_main, "ref", str(tmp_path / "ref_on_ref.trec"), [])
    score(jax_main, "port", str(tmp_path / "ref_on_port.trec"), [])
    score(port_main, "port", str(tmp_path / "port_on_port.trec"),
          ["--device", "cpu"])
    # the same reps: the same run; each package's own reps: up to ties
    fu.assert_runs_equal_up_to_ties(str(tmp_path / "port_on_port.trec"),
                                    str(tmp_path / "ref_on_port.trec"),
                                    rel=1e-6)
    fu.assert_runs_equal_up_to_ties(str(tmp_path / "port_on_port.trec"),
                                    str(tmp_path / "ref_on_ref.trec"))


# --------------------------------------------------------------- pins --


@pytest.mark.parametrize("layout", ["dhr_tied", "dhr_untied", "dense",
                                    "colbert"])
def test_bert_init_export_keeps_the_bert_layout(tmp_path, monkeypatch,
                                                layout):
    """R1: the port's export of a model trained from a BERT init carries
    ``bert.*`` keys with the token types in every tower, its ``encode``
    loads it, and ``dhr_tpu`` reads it to the trained parameters exactly;
    ``dhr_tpu``'s own export of those weights (its train verb's call:
    the init's config, the default arch) cannot be encoded."""
    import dhr_tpu.cli.main as jcli
    from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
    from dhr_tpu.train.checkpoint import export_hf_checkpoint as jax_export

    paths = fu.write_world(tmp_path)
    init = bert_init(tmp_path)
    out = train(tmp_path, paths, init, layout, steps=2)
    export, untied = str(out / "export"), layout == "dhr_untied"
    for keys in export_keys(export, untied):
        assert TOKEN_TYPES in keys
        assert not any(k.startswith("distilbert.") for k in keys)
    model = [*LAYOUTS[layout], *fu.COMMON, "--p-max-len", str(fu.P_LEN),
             "--batch-size", "8", "--input", paths["corpus"]]
    port_main(["encode", *model, "--model-name-or-path", export, "--output",
               str(tmp_path / "port.npz"), "--device", "cpu"])

    jcfg = jcli._model_cfg_from_args(_args([*LAYOUTS[layout], *fu.COMMON,
                                            "--model-name-or-path", init]))
    params = reference_params(export, jcfg, untied)
    got = flax_to_state_dict(params)
    want = trained_state(out, steps=2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)

    with open(os.path.join(init, "config.json")) as f:
        init_config = json.load(f)
    ref_export = str(tmp_path / "ref_export")
    jax_export(ref_export, params, jcfg, hf_config=init_config)
    for keys in export_keys(ref_export, untied):
        assert TOKEN_TYPES not in keys
        assert any(k.startswith("distilbert.") for k in keys)
    if untied:  # dhr_tpu reads no untied export (R2): read it as upstream
        monkeypatch.setattr(jcli, "_model_cfg_from_args", lambda a: jcfg)
        monkeypatch.setattr(jcli, "_load_init_params", lambda a, c: (
            JaxBiEncoder(c), reference_params(ref_export, c, True)))
    with pytest.raises(Exception, match="token_type"):
        jax_main(["encode", *model, "--model-name-or-path", ref_export,
                  "--output", str(tmp_path / "ref.npz")])


def test_untied_export_loads_each_tower(tmp_path):
    """R2: ``encode --untie-encoder`` on an untied export gives the port
    the trained towers and sidecar halves exactly; ``dhr_tpu`` raises on
    the same directory; a tied directory loads into both towers as before,
    and an untied export without ``--untie-encoder`` is refused by name."""
    from dhr_tpu_torch.cli.main import (
        _load_init_params, _model_cfg_from_args, build_parser)

    paths = fu.write_world(tmp_path)
    init = bert_init(tmp_path)
    out = train(tmp_path, paths, init, "dhr_untied", steps=2)
    export = str(out / "export")
    assert not os.path.exists(os.path.join(export, "config.json"))
    model = [*LAYOUTS["dhr_untied"], *fu.COMMON, "--p-max-len",
             str(fu.P_LEN), "--batch-size", "8", "--input", paths["corpus"]]
    with pytest.raises(FileNotFoundError, match="config.json"):
        jax_main(["encode", *model, "--model-name-or-path", export,
                  "--output", str(tmp_path / "ref.npz")])

    def load(path, flags=LAYOUTS["dhr_untied"]):
        args = build_parser().parse_args(
            ["encode", *flags, *fu.COMMON, "--model-name-or-path", path,
             "--input", "-", "--output", "-"])
        return _load_init_params(args, _model_cfg_from_args(args))

    got = load(export).state_dict()
    want = trained_state(out, steps=2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    port_main(["encode", *model, "--model-name-or-path", export, "--output",
               str(tmp_path / "port.npz"), "--device", "cpu"])

    tied = load(init)  # both towers from the one backbone
    for (n, q), p in zip(tied.encoder_q.backbone.named_parameters(),
                         tied.encoder_p.backbone.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    with pytest.raises(SystemExit, match="pass --untie-encoder"):
        load(export, LAYOUTS["dhr_tied"])


def test_dpr_converted_towers(tmp_path):
    """DPR's towers as ``convert_dpr_checkpoint`` writes them: bare
    ``BertModel`` keys (``embeddings.*``, ``encoder.layer.*``, DPR's
    ``pooler.dense.*``) under ``query_model/`` and ``passage_model/``.
    ``dhr_tpu`` reads neither the untied directory (no root config) nor a
    tower alone (it looks for ``bert.*`` keys); the port loads each tower
    exactly as an encoder-only checkpoint."""
    from dhr_tpu.utils.convert import convert_dpr_checkpoint
    from dhr_tpu_torch.cli.main import (
        _load_init_params, _model_cfg_from_args, build_parser)
    from dhr_tpu_torch.models.hf_io import export_hf_mlm

    cfg = RetrieverConfig(model_type="dense", encoder=BERT)
    model_dict, towers = {}, {}
    for prefix, seed in (("question_model.", 31), ("ctx_model.", 32)):
        m = load_flax_params(BiEncoder(cfg), random_flax_params(
            cfg, torch.Generator().manual_seed(seed)))
        for k, v in export_hf_mlm(m.encoder_q.backbone, BERT, "bert").items():
            model_dict[prefix + k.removeprefix("bert.")] = torch.from_numpy(v)
        model_dict[prefix + "pooler.dense.weight"] = torch.zeros(32, 32)
        model_dict[prefix + "pooler.dense.bias"] = torch.zeros(32)
        towers[prefix] = m.encoder_q.backbone.state_dict()
    torch.save({"model_dict": model_dict, "epoch": 0},
               str(tmp_path / "dpr.cp"))
    dpr = str(tmp_path / "dpr")
    convert_dpr_checkpoint(str(tmp_path / "dpr.cp"), dpr,
                           hf_config=hf_config_of(BERT, "bert"))
    paths = fu.write_world(tmp_path)
    flags = ["--model", "dense", *fu.SPECIALS, "--p-max-len", str(fu.P_LEN),
             "--batch-size", "8", "--input", paths["corpus"]]

    with pytest.raises(FileNotFoundError, match="config.json"):
        jax_main(["encode", *flags, "--untie-encoder",
                  "--model-name-or-path", dpr, "--output",
                  str(tmp_path / "ref.npz")])
    with pytest.raises(KeyError, match="bert.embeddings"):
        jax_main(["encode", *flags, "--model-name-or-path",
                  os.path.join(dpr, "query_model"), "--output",
                  str(tmp_path / "ref.npz")])

    args = build_parser().parse_args(
        ["encode", "--model", "dense", "--untie-encoder",
         "--model-name-or-path", dpr, "--input", "-", "--output", "-"])
    loaded = _load_init_params(args, _model_cfg_from_args(args))
    for enc, prefix in ((loaded.encoder_q, "question_model."),
                        (loaded.encoder_p, "ctx_model.")):
        got = enc.backbone.state_dict()
        assert sorted(got) == sorted(towers[prefix])
        for k, v in towers[prefix].items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    port_main(["encode", *flags, "--untie-encoder", "--model-name-or-path",
               dpr, "--output", str(tmp_path / "port.npz"), "--device",
               "cpu"])
    with np.load(tmp_path / "port.npz") as z:
        assert z["values"].shape == (fu.N_DOCS, 32)
        assert np.isfinite(z["values"].astype(np.float32)).all()
