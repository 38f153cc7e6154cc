"""Shared world and chain of the retriever-family tests
(``tests/test_torch_family_*.py``).

One tiny world (``--tiny``: 2 layers x 32, vocab 1,024) made from a numpy
seed: a corpus of passage ids, train groups with score-binned pairs
(``bin_pairs``, for margin-KD), queries and their qrels.  Each family
variant trains with the port's ``train`` verb on the CPU, then both
packages run ``encode`` -> ``index`` -> ``search`` -> ``eval`` from the
port's export; :func:`check_chains` holds the two chains to the encode
tests' bars (f16 values within one ulp, folds equal except at near ties)
and the runs and metrics to each other; ``encode --pack`` (four passages
a row) to the same bars, and its refusal under agg's skip-MLM.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from dhr_tpu.cli.main import main as jax_main
from dhr_tpu_torch.cli.main import main as port_main
from dhr_tpu_torch.data import collate, examples
from dhr_tpu_torch.models import BiEncoder, load_flax_params
from dhr_tpu_torch.models import random_flax_params
from dhr_tpu_torch.models.retrievers import RetrieverConfig
from dhr_tpu_torch.models.transformer import EncoderConfig
from dhr_tpu_torch.retrieval import read_run
from dhr_tpu_torch.train.checkpoint import export_hf_checkpoint
from tests.test_torch_encode import assert_f16_within_one_ulp, near_ties

V, REMOVE, OUT, AGG = 1024, 64, 96, 48  # (V - REMOVE) / OUT = 10 folds
N_DOCS, N_QUERIES, N_GROUPS = 48, 8, 16
P_LEN, Q_LEN = 24, 12
SPECIALS = ["--cls-token-id", "1", "--sep-token-id", "2"]

# the model flags of each variant (the rehearsal's family flags at tiny
# width: projection 16 instead of 128, agg 48 instead of 640, dlr 96
# instead of 768)
VARIANTS = {
    "dense_cls": ["--model", "dense", "--pooling", "cls"],
    "dense_mean": ["--model", "dense", "--pooling", "mean"],
    "agg_full": ["--model", "agg", "--agg-dim", str(AGG)],
    "agg_semi": ["--model", "agg", "--agg-dim", str(AGG),
                 "--semi-aggregate"],
    "agg_skip_mlm": ["--model", "agg", "--agg-dim", str(AGG), "--skip-mlm"],
    "dlr": ["--model", "dlr", "--dlr-out-dim", str(OUT)],
}
COMMON = ["--add-pooler", "--projection-dim", "16", "--remove-dims",
          str(REMOVE), *SPECIALS]


def write_world(root) -> dict:
    """The corpus, train groups (each with ``bin_pairs``), queries and
    qrels under ``root``; returns their paths."""
    rng = np.random.default_rng(23)
    docs = [rng.integers(REMOVE, V, int(rng.integers(4, P_LEN - 2)))
            for _ in range(N_DOCS)]
    paths = {k: str(root / f"{k}.jsonl") for k in ("corpus", "train",
                                                    "queries")}
    paths["qrels"] = str(root / "qrels.tsv")
    examples.write_jsonl(paths["corpus"], (
        {"text_id": f"d{i}", "text": t.tolist()} for i, t in enumerate(docs)))
    groups = []
    for _ in range(N_GROUPS):
        pos = rng.choice(N_DOCS, 2, replace=False)
        negs = [int(n) for n in rng.choice(N_DOCS, 6, replace=False)
                if n not in pos][:4]
        # one bin set of two bins; a pair is (positive slot, negative
        # slot, the teacher's margin)
        bins = [[[int(rng.integers(2)), int(rng.integers(len(negs))),
                  float(rng.uniform(0.5, 6.0))] for _ in range(3)]
                for _ in range(2)]
        groups.append({
            "query": rng.choice(docs[pos[0]], 5).tolist(),
            "positive_pids": [f"d{int(p)}" for p in pos],
            "negative_pids": [f"d{n}" for n in negs],
            "bin_pairs": [bins]})
    examples.write_jsonl(paths["train"], groups)
    rel = rng.choice(N_DOCS, N_QUERIES, replace=False)
    examples.write_jsonl(paths["queries"], (
        {"text_id": f"q{i}", "text": rng.choice(docs[r], 6).tolist()}
        for i, r in enumerate(rel)))
    with open(paths["qrels"], "w") as f:
        f.writelines(f"q{i}\t0\td{int(r)}\t1\n" for i, r in enumerate(rel))
    return paths


def colbert_teacher(root) -> str:
    """A tiny ColBERT teacher (random, seed 5) exported as an HF directory
    for ``train --tct --teacher-path``."""
    cfg = RetrieverConfig(model_type="colbert", add_pooler=True,
                          projection_dim=16,
                          encoder=EncoderConfig.tiny(dtype=torch.float32))
    model = load_flax_params(BiEncoder(cfg), random_flax_params(
        cfg, torch.Generator().manual_seed(5)))
    out = str(root / "teacher")
    export_hf_checkpoint(out, model, cfg)
    return out


def train(root, paths, variant, extra=()) -> str:
    """The port's ``train`` verb (tiny, f32, CPU) for a few steps; returns
    the export directory.  Asserts the per-step losses are finite."""
    out = root / f"train_{variant}"
    port_main(["train", "--tiny", *VARIANTS[variant], *COMMON,
               "--train-path", paths["train"], "--corpus-path",
               paths["corpus"], "--output-dir", str(out), "--batch-size",
               "4", "--train-n-passages", "3", "--p-max-len", str(P_LEN),
               "--q-max-len", str(Q_LEN), "--max-steps", "3",
               "--warmup-steps", "1", "--log-steps", "1", "--metrics-path",
               str(out) + ".jsonl", "--device", "cpu", *extra])
    with open(str(out) + ".jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 3 and np.isfinite(losses).all(), losses
    return str(out / "export")


def _verbs(main, who, root, paths, variant, export, searches, capsys):
    """encode (corpus and queries) -> index -> each search -> eval with one
    package; returns ``{search label: (run path, metrics)}``."""
    d = root / f"{who}_{variant}"
    d.mkdir()
    dev = ["--device", "cpu"] if who == "port" else []
    model = [*VARIANTS[variant], *COMMON, "--model-name-or-path", export,
             "--p-max-len", str(P_LEN), "--q-max-len", str(Q_LEN),
             "--batch-size", "8"]
    main(["encode", *model, "--input", paths["corpus"], "--output",
          str(d / "corpus.npz"), *dev])
    main(["encode", *model, "--input", paths["queries"], "--output",
          str(d / "q.npz"), "--encode-is-qry", *dev])
    # several passages a row; agg's skip-MLM scatter refuses packing
    pack = ["encode", *model, "--input", paths["corpus"], "--output",
            str(d / "packed.npz"), "--pack", "--pack-segments", "4", *dev]
    if variant == "agg_skip_mlm":
        with pytest.raises(SystemExit, match="skip-mlm"):
            main(pack)
    else:
        main(pack)
    index = (["--quantize", "--lex-dim", str(OUT)] if variant == "dlr"
             else [])
    main(["index", "--inputs", str(d / "corpus.npz"), "--output",
          str(d / "index.npz"), *index])
    out = {}
    for label, flags in searches.items():
        run = str(d / f"{label}.trec")
        main(["search", "--index-path", str(d / "index.npz"), "--query-path",
              str(d / "q.npz"), "--topk", "20", "--output", run, *flags,
              *dev])
        capsys.readouterr()
        main(["eval", "--qrels", paths["qrels"], "--run", run])
        out[label] = (run, json.loads(capsys.readouterr().out))
    return d, out


def assert_runs_equal_up_to_ties(got_path, want_path, rel=1e-4):
    """The same queries, scores within ``rel``, and the same document at
    every rank whose score is not tied (within ``rel`` of the query's top
    score) with a neighbour's."""
    got, want = read_run(got_path), read_run(want_path)
    assert sorted(got) == sorted(want) and len(want) == N_QUERIES
    for q, w in want.items():
        g, w = list(got[q].items()), list(w.items())  # rank order
        assert len(g) == len(w)
        ws = np.array([s for _, s in w])
        tol = rel * max(np.abs(ws).max(), 1e-30)
        np.testing.assert_allclose([s for _, s in g], ws, rtol=0, atol=tol)
        gap = np.abs(np.diff(ws)) > tol
        untied = np.r_[gap[:1], gap[1:] & gap[:-1], gap[-1:]]
        assert [d for (d, _), u in zip(g, untied) if u] == \
            [d for (d, _), u in zip(w, untied) if u], q


def _port_lexical(export, variant, texts, max_len):
    """The port model's f32 lexical reps of ``texts`` (for near ties)."""
    from dhr_tpu_torch.cli.main import (
        _load_init_params, _model_cfg_from_args, build_parser)

    args = build_parser().parse_args(
        ["encode", *VARIANTS[variant], *COMMON, "--model-name-or-path",
         export, "--input", "x", "--output", "y"])
    model = _load_init_params(args, _model_cfg_from_args(args))
    b = collate.pad_token_batch(texts, max_len, 0, 1, 2)
    with torch.no_grad():
        return model.encoder_q(torch.from_numpy(b["input_ids"]),
                               torch.from_numpy(b["attention_mask"])
                               ).lexical.numpy()


def check_chains(root, paths, variant, export, searches, capsys) -> dict:
    """Both packages' chains from the port's export: planes to the encode
    bars, indexes of the same shape, each search's runs equal up to ties,
    eval metrics equal; the reference's ``search`` over the port's index
    and queries gives the port's run.  Returns the metrics."""
    jd, jax_out = _verbs(jax_main, "ref", root, paths, variant, export,
                         searches, capsys)
    pd, port_out = _verbs(port_main, "port", root, paths, variant, export,
                          searches, capsys)
    planes = [("corpus", "corpus", P_LEN), ("q", "queries", Q_LEN)]
    if variant != "agg_skip_mlm":
        planes.append(("packed", "corpus", P_LEN))
    for name, src, max_len in planes:
        with np.load(jd / f"{name}.npz") as w, np.load(pd / f"{name}.npz") \
                as g:
            assert sorted(g.files) == sorted(w.files)
            assert_f16_within_one_ulp(g["values"], w["values"])
            if variant == "dlr":
                assert g["values"].shape[1] == OUT  # lexical only
                _, texts = examples.load_tokenized_corpus(paths[src])
                lex = _port_lexical(export, variant, texts, max_len)
                ties = near_ties(lex, OUT, REMOVE)
                assert g["indices"].dtype == w["indices"].dtype == np.uint8
                assert not ((g["indices"] != w["indices"]) & ~ties).any()
            else:
                assert "indices" not in g.files
    with np.load(jd / "index.npz") as w, np.load(pd / "index.npz") as g:
        assert sorted(g.files) == sorted(w.files)
        assert g["values"].shape == w["values"].shape
        assert g["values"].dtype == w["values"].dtype
    for label in searches:
        assert_runs_equal_up_to_ties(port_out[label][0], jax_out[label][0])
        assert port_out[label][1] == jax_out[label][1], label
        # the reference's search over the port's index and queries
        cross = str(root / f"cross_{variant}_{label}.trec")
        jax_main(["search", "--index-path", str(pd / "index.npz"),
                  "--query-path", str(pd / "q.npz"), "--topk", "20",
                  "--output", cross, *searches[label]])
        assert_runs_equal_up_to_ties(port_out[label][0], cross, rel=1e-5)
    return {label: port_out[label][1] for label in searches}
