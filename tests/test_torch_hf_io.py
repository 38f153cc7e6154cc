"""HF checkpoint import / export: the port against dhr_tpu.

Checkpoints written by ``dhr_tpu`` (``export_hf_checkpoint``:
``convert_params_to_hf_mlm`` + ``save_sidecar_head``), in DistilBERT and
BERT layouts, as ``pytorch_model.bin`` and as ``model.safetensors``, load
into the port and give the reference's reps on the same params; the port's
export loads back into ``dhr_tpu``.  The in-repo safetensors reader is
bit-equal to ``safetensors.numpy.load_file`` (used here only).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from dhr_tpu.models import hf_io as jax_hf_io
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.train.checkpoint import export_hf_checkpoint
from dhr_tpu_torch.models import BiEncoder, RetrieverConfig, load_flax_params
from dhr_tpu_torch.models import hf_io
from dhr_tpu_torch.models.flax_params import random_flax_params
from tests.test_torch_models import (
    CASES,
    assert_close_f32,
    batch,
    configs,
    flax_tree,
)


def reference_reps(jcfg, tree, ids, mask):
    jb = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    return JaxBiEncoder(jcfg).apply({"params": tree}, query=jb, passage=jb)


def port_reps(model, ids, mask):
    tb = {"input_ids": torch.from_numpy(ids),
          "attention_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        return model(query=tb, passage=tb)


def load_port_from_dir(path, kw):
    """What ``encode --model-name-or-path`` does, through the library."""
    enc = hf_io.encoder_config_from_hf(path, dtype=torch.float32)
    cfg = RetrieverConfig(encoder=enc, **kw)
    model = BiEncoder(cfg)
    load_flax_params(model, random_flax_params(
        cfg, torch.Generator().manual_seed(1)))
    hf_io.load_hf_backbone(model.encoder_q.backbone,
                           hf_io.load_hf_state_dict(path), enc)
    for name, key in (("pooler", "pooler"),
                      ("TermWeightTrans", "term_weight")):
        head = hf_io.load_sidecar_head(path, name)
        if head is not None:
            getattr(model.encoder_q, key).linear.load_state_dict(head["q"])
    return model


def to_safetensors(path):
    """Replace the directory's pytorch_model.bin with model.safetensors."""
    sd = torch.load(os.path.join(path, "pytorch_model.bin"),
                    weights_only=True)
    save_file({k: v.numpy() for k, v in sd.items()},
              os.path.join(path, "model.safetensors"))
    os.remove(os.path.join(path, "pytorch_model.bin"))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_reference_checkpoint_loads_into_the_port(tmp_path, arch, fmt):
    kw = CASES["dhr_pooler"]
    enc = {"type_vocab_size": 2} if arch == "bert" else {}
    jcfg, _ = configs(kw, **enc)
    ids, mask = batch(7)
    tree = flax_tree(jcfg, ids, mask, 7)
    export_hf_checkpoint(str(tmp_path), tree, jcfg, arch=arch)
    if fmt == "safetensors":
        to_safetensors(str(tmp_path))
    model = load_port_from_dir(str(tmp_path), kw)
    assert model.cfg.encoder.type_vocab_size == enc.get("type_vocab_size", 0)
    (tq, tp), (jq, jp) = port_reps(model, ids, mask), reference_reps(
        jcfg, tree, ids, mask)
    for got, want in ((tq, jq), (tp, jp)):
        assert_close_f32("lexical", got.lexical, want.lexical)
        assert_close_f32("semantic", got.semantic, want.semantic)


@pytest.mark.parametrize("case", ["dhr_pooler", "dense_mean_pooler",
                                  "colbert"])
@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_port_export_loads_back_into_the_reference(case, arch):
    """The port's HF export (MLM-headed, or encoder-only for families
    without an MLM head) -> dhr_tpu's import -> the same reps."""
    kw = CASES[case]
    jcfg, tcfg = configs(kw)
    model = load_flax_params(BiEncoder(tcfg), random_flax_params(
        tcfg, torch.Generator().manual_seed(2)))
    sd = hf_io.export_hf_mlm(model.encoder_q.backbone, tcfg.encoder, arch)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in sd.values())
    back = jax_hf_io.convert_hf_mlm_to_params(sd, jcfg.encoder)
    tree = random_flax_params(tcfg, torch.Generator().manual_seed(2))
    enc_q = tree["encoder_q"]
    if tcfg.needs_mlm:
        enc_q["backbone"] = back
    else:
        assert back["mlm"] is None
        enc_q["backbone"] = back["encoder"]
    ids, mask = batch(8)
    (tq, _), (jq, _) = port_reps(model, ids, mask), reference_reps(
        jcfg, tree, ids, mask)
    for f in ("dense", "lexical", "semantic", "token"):
        if getattr(jq, f) is not None:
            assert_close_f32(f, getattr(tq, f), getattr(jq, f))


def test_port_export_matches_reference_export_key_for_key():
    jcfg, tcfg = configs(CASES["dhr_pooler"], type_vocab_size=2)
    tree = random_flax_params(tcfg, torch.Generator().manual_seed(3))
    model = load_flax_params(BiEncoder(tcfg), tree)
    for arch in ("distilbert", "bert"):
        want = jax_hf_io.convert_params_to_hf_mlm(
            tree["encoder_q"]["backbone"], jcfg.encoder, arch)
        got = hf_io.export_hf_mlm(model.encoder_q.backbone, tcfg.encoder,
                                  arch)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


def test_untied_projector_is_refused():
    _, tcfg = configs(CASES["dhr_pooler"])
    model = load_flax_params(BiEncoder(tcfg), random_flax_params(
        tcfg, torch.Generator().manual_seed(4)))
    sd = hf_io.export_hf_mlm(model.encoder_q.backbone, tcfg.encoder)
    sd["vocab_projector.weight"] = sd["vocab_projector.weight"] + 1.0
    with pytest.raises(ValueError, match="untied MLM projector"):
        hf_io.hf_mlm_to_state_dict(sd, tcfg.encoder)
    with pytest.raises(ValueError, match="untied MLM projector"):
        jax_hf_io.convert_hf_mlm_to_params(sd, configs(
            CASES["dhr_pooler"])[0].encoder)


def test_encoder_only_checkpoint_needs_a_family_without_mlm():
    _, dense_cfg = configs(CASES["dense_cls"])
    dense = load_flax_params(BiEncoder(dense_cfg), random_flax_params(
        dense_cfg, torch.Generator().manual_seed(5)))
    sd = hf_io.export_hf_mlm(dense.encoder_q.backbone, dense_cfg.encoder)
    assert not any(k.startswith("vocab_") for k in sd)
    _, dhr_cfg = configs(CASES["dhr_pooler"])
    dhr = BiEncoder(dhr_cfg)
    with pytest.raises(ValueError, match="MLM-headed"):
        hf_io.load_hf_backbone(dhr.encoder_q.backbone, sd, dhr_cfg.encoder)
    fresh = BiEncoder(dense_cfg)
    hf_io.load_hf_backbone(fresh.encoder_q.backbone, sd, dense_cfg.encoder)
    for a, b in zip(fresh.state_dict().values(), dense.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tied", [True, False])
def test_sidecar_heads_round_trip_both_ways(tmp_path, tied):
    rng = np.random.default_rng(6)
    q = torch.nn.Linear(32, 16)
    p = None if tied else torch.nn.Linear(32, 16)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    hf_io.save_sidecar_head(str(port_dir), "pooler", q, p, 32, 16)
    ref = jax_hf_io.load_sidecar_head(str(port_dir), "pooler")
    assert ref["config"] == {"input_dim": 32, "output_dim": 16, "tied": tied}
    np.testing.assert_array_equal(ref["q"]["kernel"],
                                  q.weight.detach().numpy().T)
    assert (ref["p"] is None) == tied
    leaf = {"kernel": rng.standard_normal((32, 16)).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32)}
    jax_hf_io.save_sidecar_head(str(ref_dir), "TermWeightTrans", leaf,
                                None if tied else leaf, 32, 16)
    head = hf_io.load_sidecar_head(str(ref_dir), "TermWeightTrans")
    np.testing.assert_array_equal(head["q"]["weight"].numpy(),
                                  leaf["kernel"].T)
    np.testing.assert_array_equal(head["q"]["bias"].numpy(), leaf["bias"])
    assert (head["p"] is None) == tied
    assert hf_io.load_sidecar_head(str(ref_dir), "pooler") is None


@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_encoder_config_from_hf_matches_reference(tmp_path, arch):
    jcfg, _ = configs(CASES["dhr_pooler"],
                      **({"type_vocab_size": 2} if arch == "bert" else {}))
    ids, mask = batch(0)
    export_hf_checkpoint(str(tmp_path), flax_tree(jcfg, ids, mask, 0), jcfg,
                         arch=arch)
    want = jax_hf_io.encoder_config_from_hf(str(tmp_path), jnp.float32)
    got = hf_io.encoder_config_from_hf(str(tmp_path), torch.float32)
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "max_position_embeddings",
              "type_vocab_size", "layer_norm_eps", "hidden_dropout",
              "attention_dropout"):
        assert getattr(got, f) == getattr(want, f), f
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({"model_type": "roberta"}))
    with pytest.raises(ValueError, match="roberta"):
        hf_io.encoder_config_from_hf(str(tmp_path))


def test_safetensors_reader_is_bit_equal_to_the_library(tmp_path):
    rng = np.random.default_rng(9)
    tensors = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "f64": rng.standard_normal((2, 2, 2)),
        "i64": rng.integers(-2**40, 2**40, (6,)),
        "i32": rng.integers(-2**30, 2**30, (2, 3)).astype(np.int32),
        "i16": rng.integers(-300, 300, (5,)).astype(np.int16),
        "i8": rng.integers(-128, 128, (7,)).astype(np.int8),
        "u8": rng.integers(0, 256, (2, 4)).astype(np.uint8),
        "bool": rng.random((3,)) < 0.5,
        "scalar": np.asarray(3.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "nan": np.asarray([np.nan, -np.inf, -0.0], np.float32),
    }
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "np"})
    want, got = load_file(path), hf_io.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_safetensors_reader_widens_bf16(tmp_path):
    from safetensors.torch import save_file as save_torch

    t = torch.randn(3, 4).to(torch.bfloat16)
    path = str(tmp_path / "model.safetensors")
    save_torch({"w": t}, path)
    got = hf_io.read_safetensors(path)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, t.float().numpy())
