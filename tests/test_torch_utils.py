"""The port's ``utils``: the converters against ``dhr_tpu.utils`` (byte for
byte), the DPR checkpoint split, the recorder's spans and counters and the
profiler trace."""

import json
import os
import threading
import time

import pytest
import torch

from dhr_tpu.utils import convert as ref
from dhr_tpu_torch import utils
from dhr_tpu_torch.utils import profiling


def test_convert_ranking_to_trec_byte_equal(tmp_path):
    src = tmp_path / "rank.tsv"
    src.write_text("q1\td2\t1.5\nq1\td1\t2.5\nq2\td9\t-1\nq1\td0\t2.5\n"
                   "short\trow\nq2\td3\t0.25\textra\n")
    utils.convert_ranking_to_trec(str(src), str(tmp_path / "got"), "run")
    ref.convert_ranking_to_trec(str(src), str(tmp_path / "want"), "run")
    got = (tmp_path / "got").read_bytes()
    assert got == (tmp_path / "want").read_bytes()
    assert got.decode().splitlines()[:2] == ["q1 Q0 d0 1 2.5 run",
                                             "q1 Q0 d1 2 2.5 run"]


def test_tsv_readers_match_reference(tmp_path):
    pairs = tmp_path / "pairs.tsv"
    pairs.write_text("a\tfirst text\nb\tsecond\textra\nlonely\n\na\tagain\n")
    assert utils.read_tsv_pairs(str(pairs)) == ref.read_tsv_pairs(
        str(pairs)) == {"a": "again", "b": "second"}
    qrels = tmp_path / "qrels.tsv"
    qrels.write_text("q1\t0\td1\t1\nq1\t0\td2\t0\nq2\t0\td1\t2\n"
                     "q3\td1\t1\n")
    got = utils.read_qrel_tsv(str(qrels))
    assert got == ref.read_qrel_tsv(str(qrels))
    assert got == {"q1": {"d1": 1, "d2": 0}, "q2": {"d1": 2}}


@pytest.mark.parametrize("wrapped,config", [(True, {"hidden_size": 8}),
                                            (False, None)])
def test_convert_dpr_checkpoint_splits_the_two_towers(tmp_path, wrapped,
                                                      config):
    g = torch.Generator().manual_seed(0)
    sd = {"question_model.embeddings.weight": torch.randn(5, 4, generator=g),
          "question_model.pooler.bias": torch.randn(4, generator=g),
          "ctx_model.embeddings.weight": torch.randn(5, 4, generator=g),
          "other.weight": torch.randn(2, generator=g)}
    path = str(tmp_path / "dpr.pt")
    torch.save({"model_dict": sd, "epoch": 3} if wrapped else sd, path)
    utils.convert_dpr_checkpoint(path, str(tmp_path / "got"), config)
    ref.convert_dpr_checkpoint(path, str(tmp_path / "want"), config)
    for sub, prefix in (("query_model", "question_model."),
                        ("passage_model", "ctx_model.")):
        got = torch.load(tmp_path / "got" / sub / "pytorch_model.bin")
        want = torch.load(tmp_path / "want" / sub / "pytorch_model.bin")
        assert sorted(got) == sorted(want) == sorted(
            k[len(prefix):] for k in sd if k.startswith(prefix))
        for k in got:
            assert torch.equal(got[k], want[k])
            assert torch.equal(got[k], sd[prefix + k])
        cfg = tmp_path / "got" / sub / "config.json"
        assert cfg.exists() == (config is not None)
        if config is not None:
            assert cfg.read_bytes() == (
                tmp_path / "want" / sub / "config.json").read_bytes()
            assert json.loads(cfg.read_text()) == config


def test_phase_report_reset():
    """Spans sum per name into ``report`` (a span that raises is kept all
    the same) until ``reset``."""
    profiling.reset()
    for _ in range(2):
        with profiling.span("a"):
            time.sleep(0.01)
    with pytest.raises(ValueError):
        with profiling.span("b"):
            raise ValueError("timed all the same")
    rep = profiling.report()
    assert sorted(rep) == ["a", "b"]
    assert rep["a"]["count"] == 2 and rep["a"]["total_s"] >= 0.02
    assert rep["a"]["mean_s"] == pytest.approx(rep["a"]["total_s"] / 2)
    assert rep["b"]["count"] == 1
    assert len(profiling.spans("b")) == 1
    profiling.reset()
    assert profiling.report() == {}
    assert profiling.spans("a") == [] and profiling.counters() == {}


def test_spans_carry_parent_and_trace_ids_across_threads():
    """A span's parent is the span open around it on its thread; its trace
    is the root's id, or the ``trace=`` given on another thread."""
    profiling.reset()
    with profiling.span("root") as root:
        with profiling.span("child") as child:
            with profiling.span("grandchild") as grand:
                pass
        trace = profiling.current().trace
        seen = {}

        def work():
            seen["current"] = profiling.current()
            with profiling.span("remote", trace=trace) as remote:
                with profiling.span("remote.inner") as inner:
                    pass
            seen["spans"] = remote, inner

        t = threading.Thread(target=work)
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert profiling.current() is None and seen["current"] is None
    assert root.parent is None and root.trace == root.id
    assert (child.parent, grand.parent) == (root.id, child.id)
    assert child.trace == grand.trace == root.id
    remote, inner = seen["spans"]
    assert remote.parent is None and remote.trace == root.id
    assert inner.parent == remote.id and inner.trace == root.id
    assert remote.thread != root.thread == child.thread
    assert len({s.id for s in (root, child, grand, remote, inner)}) == 5
    later = profiling.record("after", root.start, root.end, trace=root.trace)
    assert later.trace == root.id and later.parent is None
    assert later.host_ms == pytest.approx(root.host_ms)


def test_ring_is_bounded_and_totals_run_on(monkeypatch):
    """Each name keeps its last ``RING`` spans and counts, and its running
    count and total over every one."""
    profiling.reset()
    monkeypatch.setattr(profiling, "RING", 8)
    made = [profiling.record("r", float(i), float(i) + 0.5)
            for i in range(20)]
    for _ in range(20):
        profiling.count("c", 2)
    assert profiling.spans("r") == made[-8:]
    rep = profiling.report()["r"]
    assert rep["count"] == 20 and rep["total_s"] == pytest.approx(10.0)
    assert profiling.counters() == {"c": 40}
    profiling.reset()


def test_window_keeps_what_lies_inside_it():
    """``spans`` and ``counters`` over a window keep the spans that start
    and end inside it and the counts made inside it."""
    profiling.reset()
    for start, end in ((0.5, 1.5), (1.0, 2.0), (1.5, 3.0), (2.5, 3.5)):
        profiling.record("w", start, end)
    got = [(s.start, s.end) for s in profiling.spans("w", 1.0, 3.0)]
    assert got == [(1.0, 2.0), (1.5, 3.0)]
    assert len(profiling.spans("w")) == 4
    t0 = time.perf_counter()
    profiling.count("n", 3)
    t1 = time.perf_counter()
    profiling.count("n", 4)
    assert profiling.counters(t0, t1) == {"n": 3}
    assert profiling.counters(t1) == {"n": 4}
    assert profiling.counters() == {"n": 7}
    profiling.reset()


def test_spans_sit_on_the_profilers_host_timeline():
    """Under an active ``torch.profiler`` a span is a host event of the
    profile, around the ops it issues."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("rec.outer"):
            with profiling.span("rec.inner", device=True) as inner:
                torch.ones(8, 8) @ torch.ones(8, 8)
    names = {e.name for e in prof.events()}
    assert {"rec.outer", "rec.inner"} <= names
    assert inner.device_ms() is None   # no CUDA: no event pair
    assert [s.name for s in profiling.spans("rec.inner")] == ["rec.inner"]


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler active a span never enters ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    with profiling.span("quiet", device=True):
        torch.ones(2) + 1
    assert profiling.report()["quiet"]["count"] == 1
    profiling.reset()


def test_kernel_launches_keep_their_keys_and_read_the_recorder():
    from dhr_tpu_torch.ops import kernel_launches

    profiling.reset()
    assert kernel_launches() == {"partial_gip": 0, "rerank_gip": 0,
                                 "gip_candidates": 0, "lexical_pool": 0,
                                 "moe_combine": 0, "mla_attention": 0,
                                 "kda_scan": 0, "ssd_scan": 0}
    profiling.count("launches.rerank_gip")
    profiling.count("launches.partial_gip", 3)
    assert kernel_launches() == {"partial_gip": 3, "rerank_gip": 1,
                                 "gip_candidates": 0, "lexical_pool": 0,
                                 "moe_combine": 0, "mla_attention": 0,
                                 "kda_scan": 0, "ssd_scan": 0}
    profiling.reset()
    assert set(kernel_launches().values()) == {0}


def test_trace_writes_the_blocks_spans_beside_its_trace(tmp_path):
    """``trace`` also writes ``spans.json``: the spans recorded inside its
    block, with their ids, and the counters."""
    profiling.reset()
    with profiling.span("before"):
        pass
    log_dir = str(tmp_path / "trace")
    with utils.trace(log_dir):
        with profiling.span("inside") as inside:
            profiling.count("inside.n")
            torch.ones(4) * 2
    with open(os.path.join(log_dir, "spans.json")) as f:
        got = json.load(f)
    assert [d["name"] for d in got["spans"]] == ["inside"]
    assert got["spans"][0]["id"] == inside.id
    assert got["spans"][0]["device_ms"] is None
    assert got["counters"] == {"inside.n": 1}
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert any(e.get("name") == "inside"
                   for e in json.load(f)["traceEvents"])
    profiling.reset()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with utils.trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


def test_train_profile_dir_writes_its_trace_through_trace(tmp_path):
    """``run_training(profile_dir=...)`` profiles the run with ``trace``:
    the Chrome trace, and the steps' spans beside it."""
    from tests.test_torch_train_driver import run

    run(tmp_path, "p", num_epochs=1, max_steps=2,
        profile_dir=str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with open(tmp_path / "prof" / "spans.json") as f:
        names = [d["name"] for d in json.load(f)["spans"]]
    assert names.count("train.step") == 2
    assert names.count("train.optimizer") == 2
