"""The port's BEIR harness against ``dhr_tpu.eval.beir``: the directory
loader, the offline dataset step, ``evaluate_beir`` on its plain, bucketed
and packed routes (one Flax tree in both packages' encoders), the self-hit
filter, and the ``beir-preprocess`` / ``beir`` verbs with the tokenizer
loader stubbed in both CLIs.  Metrics agree within 1e-6.
"""

import json
import os
import socket
import zipfile
import zlib

import numpy as np
import pytest
import torch

import dhr_tpu.cli.main as jax_cli
import dhr_tpu_torch.cli.main as cli
from dhr_tpu.encode import EncodeConfig as JaxEncodeConfig
from dhr_tpu.encode import Encoder as JaxEncoder
from dhr_tpu.eval import beir as ref
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.retrieval import SearchConfig as JaxSearchConfig
from dhr_tpu.train.checkpoint import export_hf_checkpoint
from dhr_tpu_torch.data import collate
from dhr_tpu_torch.encode import EncodeConfig, Encoder
from dhr_tpu_torch.eval import beir
from dhr_tpu_torch.models import BiEncoder, load_flax_params
from dhr_tpu_torch.retrieval import SearchConfig
from dhr_tpu_torch.retrieval.searcher import Searcher
from tests.test_torch_models import CASES, OUT, REMOVE, V, configs, flax_tree

METRICS = ("NDCG@10", "Recall@10", "R_cap@10", "NDCG@100", "Recall@100",
           "R_cap@100", "num_queries")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeTokenizer:
    """Whole words hashed into [REMOVE, V) (crc32: the same ids in every
    process)."""

    def encode(self, text, add_special_tokens=False, max_length=None,
               truncation=True):
        ids = [REMOVE + zlib.crc32(w.encode()) % (V - REMOVE)
               for w in text.split()]
        return ids[: max_length or 16] or [REMOVE]


def write_beir_dataset(d, n_docs=20, seed=0):
    """A BEIR directory: titled documents of ragged length, 4 queries with
    qrels, one without (filtered out), one whose id is a document's (the
    self-hit), a qrels header row and a 2-graded judgment."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "qrels"), exist_ok=True)
    words = [f"w{i}" for i in range(40)]
    with open(os.path.join(d, "corpus.jsonl"), "w") as f:
        for i in range(n_docs):
            body = " ".join(rng.choice(words, int(rng.integers(2, 14))))
            row = {"_id": f"c{i}", "title": f"title {i}" if i % 3 else "",
                   "text": body}
            f.write(json.dumps(row) + "\n")
    queries = [{"_id": f"q{i}", "text": " ".join(rng.choice(words, 3))}
               for i in range(5)] + [{"_id": "c0", "text": "title 0 w1"}]
    with open(os.path.join(d, "queries.jsonl"), "w") as f:
        for row in queries:
            f.write(json.dumps(row) + "\n")
    with open(os.path.join(d, "qrels", "test.tsv"), "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for i in range(4):
            f.write(f"q{i}\tc{i + 1}\t1\n")
        f.write("q0\tc7\t2\nc0\tc1\t1\n")


def test_load_beir_dir_matches_reference(tmp_path):
    write_beir_dataset(str(tmp_path))
    got = beir.load_beir_dir(str(tmp_path))
    assert got == ref.load_beir_dir(str(tmp_path))
    corpus, queries, qrels = got
    assert len(corpus) == 20 and corpus["c0"].startswith("w")
    assert corpus["c1"].startswith("title 1 ")
    assert set(queries) == {"q0", "q1", "q2", "q3", "c0"}
    assert qrels["q0"] == {"c1": 1, "c7": 2}
    assert beir.BEIR_13 == ref.BEIR_13 and beir.BEIR_URL == ref.BEIR_URL


def zip_dataset(tmp_path, name, **kw):
    src = tmp_path / "src" / name
    write_beir_dataset(str(src), **kw)
    dl = tmp_path / "download"
    dl.mkdir(exist_ok=True)
    with zipfile.ZipFile(dl / f"{name}.zip", "w") as z:
        for root, _, files in os.walk(src):
            for fn in files:
                p = os.path.join(root, fn)
                z.write(p, os.path.relpath(p, src.parent))
    return dl


@pytest.fixture
def no_network(monkeypatch):
    """Any socket opened fails the test."""

    def refuse(*a, **kw):
        raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


def test_download_beir_dataset_unzips_then_reuses(tmp_path, no_network):
    dl = zip_dataset(tmp_path, "tinyset")
    out = beir.download_beir_dataset("tinyset", str(dl))
    assert out == str(dl / "tinyset")
    assert beir.load_beir_dir(out) == ref.load_beir_dir(
        str(tmp_path / "src" / "tinyset"))
    os.unlink(dl / "tinyset.zip")  # the extracted directory is reused
    assert beir.download_beir_dataset("tinyset", str(dl)) == out


def test_download_beir_dataset_offline_error(tmp_path, no_network):
    with pytest.raises(RuntimeError, match="place the zip") as e:
        beir.download_beir_dataset("nosuchset", str(tmp_path / "dl"))
    assert str(tmp_path / "dl" / "nosuchset.zip") in str(e.value)
    assert "nosuchset.zip" in str(e.value) and "https://" in str(e.value)


def both_encoders(seed, bs=8):
    jcfg, tcfg = configs(CASES["dhr_pooler"])
    b = collate.pad_token_batch([[REMOVE + 1] * 6], 8, 0, 1, 2)
    tree = flax_tree(jcfg, b["input_ids"], b["attention_mask"], seed)
    jenc = JaxEncoder(JaxBiEncoder(jcfg), tree, jcfg,
                      JaxEncodeConfig(batch_size=bs, remove_dims=REMOVE))
    tenc = Encoder(load_flax_params(BiEncoder(tcfg), tree), tcfg,
                   EncodeConfig(batch_size=bs, remove_dims=REMOVE),
                   device="cpu")
    return jenc, tenc


@pytest.mark.parametrize("route", [
    dict(), dict(length_bucketing=True), dict(pack=True, pack_segments=3)])
@pytest.mark.parametrize("search", [
    dict(topk=10, query_batch=4),
    dict(topk=10, theta=0.0, rerank=True, agip_topk=24, query_batch=8)])
def test_evaluate_beir_matches_reference(tmp_path, route, search):
    write_beir_dataset(str(tmp_path))
    jenc, tenc = both_encoders(40)
    kw = dict(q_max_len=8, p_max_len=16, cls_id=1, sep_id=2, **route)
    want = ref.evaluate_beir(jenc, JaxSearchConfig(**search), str(tmp_path),
                             FakeTokenizer(), **kw)
    got = beir.evaluate_beir(tenc, SearchConfig(**search), str(tmp_path),
                             FakeTokenizer(), **kw)
    assert sorted(got) == sorted(want) == sorted(METRICS)
    assert got["num_queries"] == 5
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_evaluate_beir_drops_self_hits(tmp_path, monkeypatch):
    """A run that ranks a query's own id first: the filter removes it
    before the metrics, so the relevant document behind it counts at 1."""
    d = str(tmp_path)
    write_beir_dataset(d)
    search_run = Searcher.search_run

    def self_hit_first(self, qids, qv, qi=None):
        results, scores = search_run(self, qids, qv, qi)
        for q in results:
            rest = [(d, s) for d, s in zip(results[q], scores[q])
                    if d not in (q, "c1")]
            top = max(scores[q]) + 1.0  # the run is ranked by score
            results[q] = [q, "c1"] + [d for d, _ in rest]
            scores[q] = [top + 1.0, top] + [s for _, s in rest]
        return results, scores

    monkeypatch.setattr(Searcher, "search_run", self_hit_first)
    _, tenc = both_encoders(41)
    out = beir.evaluate_beir(tenc, SearchConfig(topk=10, query_batch=8), d,
                             FakeTokenizer(), q_max_len=8, p_max_len=16,
                             cls_id=1, sep_id=2, k_values=(1,))
    # each query's own id first, then c1: after the filter c1 is at rank
    # 1, one of q0's two relevant documents and c0's one; unfiltered, c0
    # would score 0 there
    assert out["Recall@1"] == pytest.approx((0.5 + 0 + 0 + 0 + 1) / 5)


# ----------------------------------------------------------------- verbs --


@pytest.fixture
def stub_tokenizers(monkeypatch):
    for mod in (jax_cli, cli):
        monkeypatch.setattr(mod, "_load_tokenizer",
                            lambda path: FakeTokenizer())


@pytest.mark.parametrize("by_name", [False, True])
def test_beir_preprocess_verb_byte_equal_to_reference(tmp_path,
                                                      stub_tokenizers,
                                                      by_name):
    dl = zip_dataset(tmp_path, "tinyset")
    src = ["--dataset", "tinyset", "--download-dir", str(dl)] if by_name \
        else ["--dataset-dir", str(tmp_path / "src" / "tinyset")]
    args = ["beir-preprocess", *src, "--tokenizer", "tok",
            "--q-max-len", "4", "--p-max-len", "9"]
    jax_cli.main(args + ["--output-dir", str(tmp_path / "want")])
    cli.main(args + ["--output-dir", str(tmp_path / "got"), "--device",
                     "cpu"])
    for name in ("corpus.jsonl", "queries.jsonl", "qrels.tsv"):
        got = (tmp_path / "got" / name).read_bytes()
        assert got and got == (tmp_path / "want" / name).read_bytes(), name


@pytest.fixture
def beir_verb_world(tmp_path):
    """Two zipped datasets and an HF checkpoint (dhr, pooler) written by
    dhr_tpu, loaded by both CLIs."""
    jcfg, _ = configs(CASES["dhr_pooler"])
    b = collate.pad_token_batch([[REMOVE + 1] * 6], 8, 0, 1, 2)
    ckpt = str(tmp_path / "ckpt")
    export_hf_checkpoint(ckpt, flax_tree(jcfg, b["input_ids"],
                                         b["attention_mask"], 42), jcfg)
    zip_dataset(tmp_path, "seta", seed=1)
    dl = zip_dataset(tmp_path, "setb", n_docs=14, seed=2)
    args = ["beir", "--model", "dhr", "--model-name-or-path", ckpt,
            "--add-pooler", "--dlr-out-dim", str(OUT), "--remove-dims",
            str(REMOVE), "--cls-token-id", "1", "--sep-token-id", "2",
            "--q-max-len", "8", "--p-max-len", "16", "--batch-size", "8",
            "--topk", "10", "--length-bucketing", "--download-dir", str(dl)]
    return tmp_path, args


def test_beir_verb_suite_matches_reference(beir_verb_world, stub_tokenizers,
                                           capsys):
    """``beir --datasets a,b`` over local zips: the per-dataset table and
    the averages (the reference's README aggregation)."""
    _, args = beir_verb_world
    jax_cli.main(args + ["--datasets", "seta,setb"])
    want = json.loads(capsys.readouterr().out)
    cli.main(args + ["--datasets", "seta,setb", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got["num_completed"] == want["num_completed"] == 2
    assert set(got["datasets"]) == {"seta", "setb"}
    for name, w in want["datasets"].items():
        for k in METRICS:
            assert got["datasets"][name][k] == pytest.approx(w[k], abs=1e-6)
    for k in ("avg_NDCG@10", "avg_R_cap@100"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)


def test_beir_verb_one_directory_and_a_missing_dataset(beir_verb_world,
                                                       stub_tokenizers,
                                                       no_network, capsys):
    root, args = beir_verb_world
    cli.main(args + ["--dataset-dir", str(root / "src" / "seta"),
                     "--device", "cpu"])
    one = json.loads(capsys.readouterr().out)
    assert sorted(one) == sorted(METRICS) and one["num_queries"] == 5
    cli.main(args + ["--datasets", "seta,nosuchset", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["num_completed"] == 1
    assert "place the zip" in out["datasets"]["nosuchset"]["error"]
    assert out["avg_NDCG@10"] == pytest.approx(one["NDCG@10"], abs=1e-12)


def test_beir_verb_refusals(beir_verb_world, stub_tokenizers):
    root, args = beir_verb_world
    d = ["--dataset-dir", str(root / "src" / "seta"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(args + d + ["--pack"])
    with pytest.raises(SystemExit, match="--dataset-dir DIR or --datasets"):
        cli.main(args[:1] + ["--device", "cpu"])
    no_path = [a for a in args if a not in ("--model-name-or-path",
                                            args[args.index(
                                                "--model-name-or-path")
                                                + 1])]
    with pytest.raises(SystemExit, match="--tokenizer"):
        cli.main(no_path + d)
