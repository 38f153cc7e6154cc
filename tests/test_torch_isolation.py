"""dhr_tpu_torch stands alone: no JAX, Flax, transformers or safetensors,
nothing of dhr_tpu, and no silent CPU fallback where the GPU is the
default."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dhr_tpu_torch.retrieval import DeviceIndex, PackedIndex, SearchConfig
from dhr_tpu_torch.retrieval import Searcher
from dhr_tpu_torch.retrieval.synth import synth_reps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import dhr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dhr_tpu_torch.__path__,
                                               "dhr_tpu_torch.")
         if m.name != "dhr_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "dhr_tpu" or m.startswith("dhr_tpu.")
             or m.split(".")[0] in ("flax", "transformers", "safetensors"))
print(len(names), bad)
assert "dhr_tpu_torch.cli.main" in names and "dhr_tpu_torch.ops._build" in names
assert "dhr_tpu_torch.models.hf_io" in names and "dhr_tpu_torch.encode" in names
new = {"dhr_tpu_torch.train." + m for m in (
    "loss", "optimizer", "state", "step", "checkpoint", "driver")}
new |= {"dhr_tpu_torch.data." + m for m in ("sampling", "loader", "tokenize")}
new |= {"dhr_tpu_torch.serve", "dhr_tpu_torch.native",
        "dhr_tpu_torch.retrieval.stats"}
new |= {"dhr_tpu_torch.densify_offline." + m for m in (
    "bm25", "corpus", "query")}
new |= {"dhr_tpu_torch.retrieval.colbert", "dhr_tpu_torch.eval.rerank",
        "dhr_tpu_torch.eval.beir", "dhr_tpu_torch.utils.convert",
        "dhr_tpu_torch.utils.profiling"}
new |= {"dhr_tpu_torch.parallel.mesh", "dhr_tpu_torch.parallel.tp",
        "dhr_tpu_torch.parallel.collectives"}
new |= {"dhr_tpu_torch.tools." + m for m in (
    "k1_ablation", "pipeline_rehearsal", "rep_stats", "recall_table",
    "escalation_probe")}
assert new <= set(names), new - set(names)
assert not bad, bad
"""


def _imports(path):
    """Top-level module names that a source file imports, anywhere in it
    (function bodies included)."""
    import ast

    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


_FORBIDDEN = ("jax", "jaxlib", "flax", "dhr_tpu", "tools")


def test_port_imports_no_jax_and_no_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]")


def test_tools_and_chip_smoke_import_no_jax_dhr_tpu_or_tools():
    """Every module under dhr_tpu_torch/tools/ and chip_smoke.py import,
    even inside functions, nothing of JAX, dhr_tpu or the JAX package's
    tools/ (the rehearsal runs ``python -m dhr_tpu_torch``, not
    ``dhr_tpu``)."""
    tools = os.path.join(ROOT, "dhr_tpu_torch", "tools")
    files = [os.path.join(tools, f) for f in sorted(os.listdir(tools))
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) >= 7
    for path in files:
        bad = {m for m in _imports(path)
               if m.split(".")[0] in _FORBIDDEN}
        assert not bad, (path, bad)
        src = open(path).read()
        assert '"-m", "dhr_tpu"' not in src, path
        assert "reference_harness" not in src, path


def _packed():
    rng = np.random.default_rng(0)
    return PackedIndex(rng.random((8, 6)).astype(np.float16),
                       rng.integers(0, 3, (8, 4)).astype(np.uint8),
                       np.asarray([str(i) for i in range(8)], dtype=object), 4)


def test_entry_points_default_to_the_gpu(monkeypatch):
    """Without CUDA, the default device raises instead of using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceIndex.from_packed(_packed())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceIndex.from_arrays(np.zeros((2, 6), np.int8),
                                np.zeros((2, 4), np.int8), ["a", "b"], 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth_reps(0, 4)
    index = DeviceIndex.from_packed(_packed(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Searcher(index, SearchConfig())
    searcher = Searcher(index, SearchConfig(topk=3), device="cpu")
    scores, rows = searcher.search(np.ones((2, 6), np.float32))
    assert scores.shape == rows.shape == (2, 3)


def test_cli_search_without_gpu_fails_unless_cpu_is_asked(tmp_path,
                                                           monkeypatch):
    import json

    from dhr_tpu_torch.cli.main import main
    from dhr_tpu_torch.retrieval import read_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _packed().save(str(tmp_path / "idx.npz"))
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "q.npz", values=rng.random((3, 6)).astype(np.float32),
             indices=rng.integers(0, 3, (3, 4)).astype(np.int32))
    (tmp_path / "q.npz.qids.json").write_text(json.dumps(["a", "b", "c"]))
    args = ["search", "--index-path", str(tmp_path / "idx.npz"),
            "--query-path", str(tmp_path / "q.npz"), "--topk", "5",
            "--brute-force", "--output", str(tmp_path / "run.trec")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    main(args + ["--device", "cpu"])
    run = read_run(str(tmp_path / "run.trec"))
    assert sorted(run) == ["a", "b", "c"]
    assert all(len(docs) == 5 for docs in run.values())
    # sharding is ported; it too runs on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args + ["--shard-over-devices"])


def test_encoder_and_encode_verb_default_to_the_gpu(tmp_path, monkeypatch):
    """Without CUDA the Encoder and the encode verb raise unless the CPU is
    asked for."""
    import json

    from dhr_tpu_torch.cli.main import main
    from dhr_tpu_torch.encode import Encoder
    from dhr_tpu_torch.models import BiEncoder, EncoderConfig, RetrieverConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RetrieverConfig(encoder=EncoderConfig.tiny(dtype=torch.float32),
                          dlr_out_dim=64, add_pooler=True)
    model = BiEncoder(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Encoder(model, cfg)
    assert Encoder(model, cfg, device="cpu").device.type == "cpu"
    (tmp_path / "c.jsonl").write_text(json.dumps(
        {"text_id": "a", "text": [100, 200]}) + "\n")
    args = ["encode", "--tiny", "--add-pooler", "--dlr-out-dim", "64",
            "--remove-dims", "64", "--cls-token-id", "1", "--sep-token-id",
            "2", "--p-max-len", "8", "--input", str(tmp_path / "c.jsonl"),
            "--output", str(tmp_path / "e.npz")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert not (tmp_path / "e.npz").exists()
    main(args + ["--device", "cpu"])
    assert PackedIndex.load(str(tmp_path / "e.npz")).values.shape == (1, 192)


def test_serve_and_unicoil_encoder_default_to_the_gpu(tmp_path,
                                                      monkeypatch):
    """Without CUDA the serve verb and the uniCOIL query encoder raise
    unless the CPU is asked for; neither drops to the CPU quietly."""
    from dhr_tpu_torch import serve as serve_mod
    from dhr_tpu_torch.cli.main import main
    from dhr_tpu_torch.densify_offline import make_unicoil_query_encoder
    from dhr_tpu_torch.models import BiEncoder, EncoderConfig, RetrieverConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RetrieverConfig(model_type="agg", skip_mlm=True, agg_dim=48,
                          encoder=EncoderConfig.tiny(dtype=torch.float32))
    model = BiEncoder(cfg)

    class Tok:
        def encode(self, text, **kw):
            return [100 + len(w) for w in text.split()]

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_unicoil_query_encoder(model, Tok())
    enc = make_unicoil_query_encoder(model, Tok(), cls_id=1, device="cpu")
    assert isinstance(enc("two words"), dict)

    _packed().save(str(tmp_path / "idx.npz"))
    served = []
    monkeypatch.setattr(serve_mod, "serve_service",
                        lambda service, **kw: served.append(service))
    args = ["serve", "--index-path", str(tmp_path / "idx.npz"), "--topk",
            "3", "--port", "0"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert not served
    main(args + ["--device", "cpu"])
    (service,) = served
    assert service.searcher.device.type == "cpu"
    assert service.searcher.index.device.type == "cpu"


def test_eval_slice_defaults_to_the_gpu(tmp_path, monkeypatch):
    """Without CUDA, MaxSim retrieval, the pair scorer and the
    ``colbert-score`` verb raise unless the CPU is asked for."""
    import json

    from dhr_tpu_torch.cli.main import main
    from dhr_tpu_torch.eval.rerank import make_pair_scorer
    from dhr_tpu_torch.models import BiEncoder, EncoderConfig, RetrieverConfig
    from dhr_tpu_torch.retrieval.colbert import full_ranking, score_pairs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3, 4)).astype(np.float16)
    p = rng.standard_normal((5, 6, 4)).astype(np.float16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        full_ranking(q, p, topk=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        score_pairs(q, ["a", "b"], p, list("vwxyz"), [("a", "v")])
    assert full_ranking(q, p, topk=3, device="cpu")[1].shape == (2, 3)
    cfg = RetrieverConfig(model_type="colbert", projection_dim=8,
                          encoder=EncoderConfig.tiny(dtype=torch.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pair_scorer(BiEncoder(cfg), cfg)
    for name, reps, ids in (("q", q, ["a", "b"]), ("p", p, list("vwxyz"))):
        np.savez(tmp_path / f"{name}.npz", token=reps)
        (tmp_path / f"{name}.npz.ids.json").write_text(json.dumps(ids))
    args = ["colbert-score", "--query-reps", str(tmp_path / "q.npz"),
            "--passage-reps", str(tmp_path / "p.npz"), "--full-ranking",
            "--topk", "3", "--output", str(tmp_path / "run.trec")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    assert not (tmp_path / "run.trec").exists()
    main(args + ["--device", "cpu"])
    assert len((tmp_path / "run.trec").read_text().splitlines()) == 6
