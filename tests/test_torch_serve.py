"""The port's search service against dhr_tpu's, and its behaviour over real
HTTP on a random port.

Parity (same seeded index and queries through both packages' services, the
port on the CPU): ``/search`` ids exact and scores within 1e-5 relative,
``/search_text`` with the port's model loaded from the reference's Flax
tree (ids exact; scores as far as the encoders' f16 query planes allow),
``/stats`` keys and values, and reload.  Then the reference's behavioural
cases (``tests/test_serve.py``) on the port: coalescing and demux, overflow
carry, mixed widths, duplicate qids, 503 shedding, token refusal, reload
under load, free-first release / failure / recovery, the listen backlog,
``tools/serve_client.py`` unchanged, a serialised query encoder under
concurrent text requests, the recorder's queue and encoder-lock waits in
``/stats``, and the ``serve`` verb in-process (stub
tokenizer) and as a process stopped by SIGINT.
"""

import contextlib
import gc
import importlib.util
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref
from concurrent.futures import ThreadPoolExecutor
from http.server import HTTPServer, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dhr_tpu.encode import EncodeConfig as JEncodeConfig
from dhr_tpu.encode import Encoder as JEncoder
from dhr_tpu.encode import make_query_encoder as jmake_query_encoder
from dhr_tpu.models.retrievers import BiEncoder as JBiEncoder
from dhr_tpu.retrieval import DeviceIndex as JDeviceIndex
from dhr_tpu.retrieval import PackedIndex as JPackedIndex
from dhr_tpu.retrieval import SearchConfig as JSearchConfig
from dhr_tpu.retrieval import Searcher as JSearcher
from dhr_tpu.serve import SearchService as JSearchService
from dhr_tpu.serve import make_handler as jmake_handler
from dhr_tpu_torch import serve as serve_mod
from dhr_tpu_torch.cli import main as tcli
from dhr_tpu_torch.data.collate import collate_encode, wrap_specials
from dhr_tpu_torch.encode import EncodeConfig, Encoder, make_query_encoder
from dhr_tpu_torch.models import BiEncoder, load_flax_params
from dhr_tpu_torch.retrieval import (
    DeviceIndex,
    PackedIndex,
    SearchConfig,
    Searcher,
)
from dhr_tpu_torch.serve import (
    MicroBatcher,
    SearchService,
    make_handler,
)
from dhr_tpu_torch.utils import profiling
from tests.test_torch_models import OUT, REMOVE, batch, configs, flax_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- helpers --


def _packed(rng, n, tag, dim=12, lex=12):
    values = (rng.random((n, dim)) + 0.1).astype(np.float16)
    indices = rng.integers(0, 3, (n, lex)).astype(np.uint8)
    docids = np.asarray([f"{tag}{i}" for i in range(n)], dtype=object)
    return PackedIndex(values, indices, docids, lex_dim=lex)


def _device(packed):
    return DeviceIndex.from_packed(packed, device="cpu")


def _searcher(packed_or_index, **cfg):
    idx = (packed_or_index if isinstance(packed_or_index, DeviceIndex)
           else _device(packed_or_index))
    return Searcher(idx, SearchConfig(**cfg), device="cpu")


def _loader(path):
    return _device(PackedIndex.load(path))


def _q(packed, rows):
    return (packed.values[rows].astype(np.float32),
            packed.indices[rows].astype(np.int32))


@contextlib.contextmanager
def running(service, handler=make_handler, threaded=True):
    cls = ThreadingHTTPServer if threaded else HTTPServer
    server = cls(("127.0.0.1", 0), handler(service))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _post_code(port, path, payload, headers=None):
    """(HTTP status, body, Retry-After header)."""
    try:
        return 200, _post(port, path, payload, headers), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _assert_same_results(got, want, rel=1e-5):
    assert got["results"] == want["results"]
    assert set(got["scores"]) == set(want["scores"])
    for q, w in want["scores"].items():
        np.testing.assert_allclose(got["scores"][q], w, rtol=rel, atol=0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------- parity with dhr_tpu --


def _both(packed, cfg, **kw):
    """(port service, reference service) over one packed index."""
    port = SearchService(Searcher(_device(packed), SearchConfig(**cfg),
                                  device="cpu"), **kw)
    jpacked = JPackedIndex(packed.values, packed.indices, packed.docids,
                           packed.lex_dim)
    ref = JSearchService(JSearcher(JDeviceIndex.from_packed(jpacked),
                                   JSearchConfig(**cfg)), **kw)
    return port, ref


SEARCH_CFGS = {
    "brute_force": dict(topk=5, theta=0.0, query_batch=4),
    "theta_rerank": dict(topk=5, theta=0.3, rerank=True, agip_topk=24,
                         max_important_dims=6, query_batch=4),
    "lam_cls_tail": dict(topk=7, theta=0.0, lam=0.5, query_batch=8),
}


@pytest.mark.parametrize("name", sorted(SEARCH_CFGS))
@pytest.mark.parametrize("micro_batch_ms", [0.0, 5.0])
def test_search_matches_reference_service(rng, name, micro_batch_ms):
    packed = _packed(rng, 64, "d", dim=16, lex=12)
    port, ref = _both(packed, SEARCH_CFGS[name],
                      micro_batch_ms=micro_batch_ms)
    qv = (rng.random((6, 16)) + 0.05).astype(np.float32)
    qi = rng.integers(0, 3, (6, 12)).astype(np.int32)
    payloads = [
        {"values": qv.tolist(), "indices": qi.tolist(),
         "qids": [f"q{i}" for i in range(6)]},
        {"values": qv[:1].tolist(), "indices": qi[:1].tolist()},  # no qids
    ]
    with running(port, threaded=micro_batch_ms > 0) as tp, \
            running(ref, jmake_handler, threaded=micro_batch_ms > 0) as jp:
        for p in payloads:
            _assert_same_results(_post(tp, "/search", p),
                                 _post(jp, "/search", p))
        assert _shared(_get(tp, "/stats")) == _get(jp, "/stats")
        assert _get(tp, "/healthz") == _get(jp, "/healthz")
    assert port.stats()["sharded_over"] == 1


def _shared(stats: dict) -> dict:
    """The port's ``/stats`` without the keys the reference lacks (the
    recorder's wait quantiles), each checked for its shape."""
    out = dict(stats)
    for key in ("queue_wait_ms", "encode_lock_wait_ms"):
        if key in out:
            q = out.pop(key)
            assert set(q) == {"n", "p50", "p95"}
            assert q["n"] == 0 or 0 <= q["p50"] <= q["p95"]
    return out


def test_stats_match_reference_with_both_routes_and_escalation(rng):
    packed = _packed(rng, 64, "d")
    cfg = dict(topk=5, theta=0.05, rerank=True, agip_topk=40, query_batch=8,
               approx_candidates=False, escalate_pool=10,
               escalate_margin=1e30)
    port, ref = _both(packed, cfg)
    port = SearchService(port.searcher, micro_batch_ms=20.0, max_pending=32,
                         small_searcher=Searcher(port.searcher.index,
                                                 SearchConfig(**{**cfg,
                                                    "query_batch": 2}),
                                                 device="cpu"),
                         index_loader=_loader)
    ref = JSearchService(ref.searcher, micro_batch_ms=20.0, max_pending=32,
                         small_searcher=JSearcher(ref.searcher.index,
                                                  JSearchConfig(**{**cfg,
                                                     "query_batch": 2})),
                         index_loader=lambda p: None)
    qv, qi = _q(packed, [3, 4, 5])
    for svc in (port, ref):
        svc.search({"qids": ["a"], "values": qv[:1].tolist(),
                    "indices": qi[:1].tolist()})  # low-latency route
        svc.search({"qids": ["a", "b", "c"], "values": qv.tolist(),
                    "indices": qi.tolist()})     # main route
    assert _shared(port.stats()) == ref.stats()
    assert port.stats()["escalated_queries"] == 4
    assert port.stats()["low_latency_batches_run"] == 1


def test_reload_matches_reference(rng, tmp_path):
    old, new = _packed(rng, 32, "old"), _packed(rng, 48, "new")
    path = str(tmp_path / "new.npz")
    new.save(path)
    cfg = dict(topk=5, theta=0.0, query_batch=4)
    port, ref = _both(old, cfg, micro_batch_ms=2.0)
    port.index_loader = _loader
    ref.index_loader = lambda p: JDeviceIndex.from_packed(JPackedIndex.load(p))
    qv, qi = _q(new, [0, 1])
    p = {"values": qv.tolist(), "indices": qi.tolist(), "qids": ["a", "b"]}
    for free_first in (False, True):
        body = {"index_path": path, "free_first": free_first}
        assert port.reload(body) == ref.reload(body)
        _assert_same_results(port.search(p), ref.search(p))
        assert _shared(port.stats()) == ref.stats()
    assert port.search(p)["results"]["a"][0] == "new0"


class FakeTokenizer:
    def encode(self, text, add_special_tokens=False, max_length=None,
               truncation=True):
        ids = [REMOVE + sum(map(ord, w)) % 900 for w in text.split()]
        return ids[: max_length or 16] or [REMOVE]


def _text_world():
    """A tiny DHR model in both packages from one Flax tree, an index of
    the reference's encoding of 24 texts, and each package's query
    encoder."""
    jcfg, tcfg = configs(dict(model_type="dhr", add_pooler=True,
                              dlr_out_dim=OUT))
    ids, mask = batch(0)
    tree = flax_tree(jcfg, ids, mask, 0)
    tok = FakeTokenizer()
    texts = [f"doc number {i} about topic {i % 5} and {i * 7}"
             for i in range(24)]
    jenc = JEncoder(JBiEncoder(jcfg), tree, jcfg,
                    JEncodeConfig(batch_size=8, remove_dims=REMOVE))
    toks = [wrap_specials(tok.encode(t, max_length=10), 12, 1, 2)
            for t in texts]
    packed = jenc.encode_corpus(iter([collate_encode(
        [f"d{i}" for i in range(24)], toks, 12)]))
    packed = PackedIndex(packed.values, packed.indices, packed.docids,
                         packed.lex_dim)
    jq = jmake_query_encoder(jenc, tok, 12, 1, 2)
    enc = Encoder(load_flax_params(BiEncoder(tcfg), tree), tcfg,
                  EncodeConfig(batch_size=8, remove_dims=REMOVE),
                  device="cpu")
    tq = make_query_encoder(enc, tok, 12, 1, 2)
    return packed, texts, tq, jq


def test_search_text_matches_reference_service():
    """The two encoders' f16 query planes agree within one f16 ulp (the
    encode parity bound): ids are exact, and scores within 1e-5 relative
    plus what the planes' difference can move them (sum |dq| x max |v|).
    The reference service fed the port's planes gives the port's scores
    within 1e-5 relative."""
    packed, texts, tq, jq = _text_world()
    queries = [texts[3], texts[7], "topic 2 and something new"]
    tv, ti = tq(queries)
    jv, ji = (np.asarray(x) for x in jq(queries))
    assert np.array_equal(ti, ji)
    ulp = np.spacing(np.maximum(np.abs(tv), np.abs(jv)))
    assert (np.abs(tv.astype(np.float32) - jv) <= ulp).all()
    moved = (np.abs(tv.astype(np.float32) - jv).sum(axis=1)
             * np.abs(packed.values.astype(np.float32)).max())
    cfg = dict(topk=6, theta=0.0, query_batch=4)
    port, ref = _both(packed, cfg, micro_batch_ms=5.0)
    port.query_encoder, ref.query_encoder = tq, jq
    qids = ["a", "b", "c"]
    payload = {"queries": queries, "qids": qids}
    with running(port) as tp, running(ref, jmake_handler) as jp:
        got = _post(tp, "/search_text", payload)
        want = _post(jp, "/search_text", payload)
        assert got["results"] == want["results"]
        for q, m in zip(qids, moved):
            w = np.asarray(want["scores"][q])
            assert (np.abs(np.asarray(got["scores"][q]) - w)
                    <= 1e-5 * np.abs(w) + m).all()
        fed = _post(jp, "/search", {"values": tv.astype(np.float32).tolist(),
                                    "indices": ti.tolist(), "qids": qids})
        _assert_same_results(got, fed)
    assert all(len(r) == 6 for r in got["results"].values())
    with pytest.raises(ValueError, match="query encoder"):
        SearchService(port.searcher).search_text({"queries": ["x"]})


def test_search_text_serialises_the_encoder_under_concurrent_requests():
    """Handler threads share one query encoder: it runs one call at a time,
    and every response equals encoding plus a direct search."""
    packed, texts, tq, _ = _text_world()
    searcher = _searcher(packed, topk=6, theta=0.0, query_batch=4)
    active, seen = [0], []
    lock = threading.Lock()

    def watched(queries):
        with lock:
            active[0] += 1
            seen.append(active[0])
        try:
            time.sleep(0.002)
            return tq(queries)
        finally:
            with lock:
                active[0] -= 1

    service = SearchService(searcher, micro_batch_ms=3.0,
                            query_encoder=watched)
    want = {}
    for i, t in enumerate(texts[:12]):
        v, ind = tq([t])
        want[i] = searcher.search_run(["q"], v, ind)[0]["q"]
    with running(service) as port:
        def one(i):
            return i, _post(port, "/search_text",
                            {"queries": [texts[i]], "qids": ["q"]})
        with ThreadPoolExecutor(max_workers=8) as ex:
            got = dict(ex.map(one, range(12)))
    assert max(seen) == 1 and len(seen) == 12
    for i in range(12):
        assert got[i]["results"]["q"] == want[i]


def test_queue_wait_and_encode_lock_wait_reach_stats(rng):
    """A searcher that holds its first pool makes the second request wait
    in the queue: ``serve.queue_wait`` records that wait on the worker
    under the request's own trace, and ``/stats`` reports it and the
    encoder lock's wait."""
    packed = _packed(rng, 32, "d")
    real = _searcher(packed, topk=5, theta=0.0, query_batch=1)
    entered, release = threading.Event(), threading.Event()

    class Holding:
        config, index, escalated_queries = real.config, real.index, 0

        def search_run(self, qids, values, indices):
            entered.set()
            assert release.wait(30)
            return real.search_run(qids, values, indices)

    service = SearchService(Holding(), micro_batch_ms=0.5,
                            query_encoder=lambda qs: _q(packed,
                                                        [0] * len(qs)))
    qv, qi = _q(packed, [1])
    profiling.reset()
    out = {}
    with running(service) as port:
        first = threading.Thread(target=lambda: out.setdefault(
            "text", _post(port, "/search_text",
                          {"queries": ["a"], "qids": ["a"]})))
        second = threading.Thread(target=lambda: out.setdefault(
            "vec", _post(port, "/search", {"values": qv.tolist(),
                                           "indices": qi.tolist(),
                                           "qids": ["b"]})))
        first.start()
        assert entered.wait(30)
        second.start()
        deadline = time.monotonic() + 30
        while service.batcher._q.qsize() == 0:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        time.sleep(0.05)
        release.set()
        for t in (first, second):
            t.join(30)
            assert not t.is_alive()
        stats = _get(port, "/stats")
    assert out["text"]["results"]["a"][0] == "d0"
    assert out["vec"]["results"]["b"][0] == "d1"
    waits = profiling.spans("serve.queue_wait")
    requests = profiling.spans("serve.request")
    assert len(waits) == len(requests) == 2
    assert sorted(w.trace for w in waits) == sorted(r.trace
                                                    for r in requests)
    assert all(w.thread == service.batcher._worker.ident for w in waits)
    by_trace = {w.trace: w for w in waits}
    held = by_trace[max(requests, key=lambda r: r.start).trace]
    assert held.host_ms >= 50
    ms = [w.host_ms for w in waits]
    assert stats["queue_wait_ms"] == {
        "n": 2, "p50": pytest.approx(float(np.percentile(ms, 50))),
        "p95": pytest.approx(float(np.percentile(ms, 95)))}
    locks = profiling.spans("serve.encode_lock_wait")
    assert len(locks) == 1 and stats["encode_lock_wait_ms"]["n"] == 1
    assert stats["encode_lock_wait_ms"]["p50"] == pytest.approx(
        locks[0].host_ms)
    assert len(profiling.spans("serve.encode")) == 1
    assert len(profiling.spans("serve.search_run")) == 2
    service.close()
    profiling.reset()


# --------------------------------------------------- behavioural cases --


@pytest.mark.parametrize("threaded", [False, True])
def test_http_service_roundtrip(rng, threaded):
    packed = _packed(rng, 32, "d")
    service = SearchService(_searcher(packed, topk=5, theta=0.0,
                                      query_batch=4),
                            micro_batch_ms=5.0 if threaded else 0.0)
    qv, qi = _q(packed, [0, 1])
    with running(service, threaded=threaded) as port:
        assert _get(port, "/healthz") == {"status": "ok", "rows": 32}
        stats = _get(port, "/stats")
        assert stats["rows"] == 32 and stats["mode"] == "gip"
        out = _post(port, "/search", {"values": qv.tolist(),
                                      "indices": qi.tolist(),
                                      "qids": ["q0", "q1"]})
        assert set(out["results"]) == {"q0", "q1"}
        assert len(out["results"]["q0"]) == 5
        assert out["results"]["q0"][0] == "d0"  # self-match first
        assert _post_code(port, "/search", {})[0] == 400
        assert _post_code(port, "/nope", {})[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404


def test_micro_batcher_coalesces_and_demuxes(rng):
    """Concurrent requests pool into one batch; each caller gets only its
    own rows, even when every request uses the same qid."""
    packed = _packed(rng, 32, "d")
    searcher = _searcher(packed, topk=5, theta=0.0, query_batch=8)
    want = {i: searcher.search_run(["q"], *_q(packed, [i]))[0]["q"]
            for i in range(4)}
    batcher = MicroBatcher(searcher, window_ms=500.0)
    got, errs = {}, []

    def one(i):
        try:
            r, s = batcher.search(["q"], *_q(packed, [i]))
            got[i] = r["q"]
            assert len(s["q"]) == 5
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    for i in range(4):
        assert got[i] == want[i] and got[i][0] == f"d{i}"
    assert batcher.batches_run <= 2
    assert batcher.max_batch_seen >= 2
    assert batcher.queries_run == 4


def test_micro_batcher_low_latency_route(rng):
    packed = _packed(rng, 32, "d")
    idx = _device(packed)
    big = _searcher(idx, topk=5, theta=0.0, query_batch=8)
    small = _searcher(idx, topk=5, theta=0.0, query_batch=2)
    assert small.index is big.index  # one copy of the planes
    batcher = MicroBatcher(big, window_ms=1.0, small_searcher=small)
    r, _ = batcher.search(["q"], *_q(packed, [3]))
    assert r["q"][0] == "d3"
    assert batcher.small_batches_run == 1
    r8, _ = batcher.search([f"q{i}" for i in range(8)], *_q(packed, range(8)))
    assert all(r8[f"q{i}"][0] == f"d{i}" for i in range(8))
    assert batcher.small_batches_run == 1  # a full pool took the big route


def test_micro_batcher_rejects_malformed_without_poisoning_pool(rng):
    packed = _packed(rng, 16, "d")
    batcher = MicroBatcher(_searcher(packed, topk=3, theta=0.0,
                                     query_batch=4), window_ms=1.0)
    qv, qi = _q(packed, [0, 1])
    with pytest.raises(ValueError, match="need one"):
        batcher.search(["a"], qv, qi)
    with pytest.raises(ValueError, match="indices rows"):
        batcher.search(["a", "b"], qv, qi[:1])
    r, _ = batcher.search(["q"], qv[:1], qi[:1])
    assert r["q"][0] == "d0"
    # mixed dense / lexical requests in one pool: run one by one
    outs = {}

    def go(tag, v, i):
        try:
            outs[tag] = batcher.search([tag], v, i)[0][tag]
        except Exception as e:  # noqa: BLE001
            outs[tag] = e

    t1 = threading.Thread(target=go, args=("x", qv[:1], qi[:1]))
    t2 = threading.Thread(target=go, args=("y", qv[:1], None))
    t1.start(); t2.start(); t1.join(30); t2.join(30)
    assert list(outs["x"])[0] == "d0"
    r, _ = batcher.search(["z"], qv[1:2], qi[1:2])
    assert r["z"][0] == "d1"


def test_micro_batcher_mixed_widths_run_per_request(rng):
    """Two query widths in one pool cannot share a batch: each request runs
    alone and gets what a direct search gives it (both packages ignore the
    dims past the index's width)."""
    packed = _packed(rng, 16, "d")
    searcher = _searcher(packed, topk=3, theta=0.0, query_batch=8)
    batcher = MicroBatcher(searcher, window_ms=300.0)
    qv, qi = _q(packed, [2])
    wide = np.pad(qv, ((0, 0), (0, 4)))
    outs = {}

    def go(tag, v, i):
        try:
            outs[tag] = batcher.search([tag], v, i)[0][tag]
        except Exception as e:  # noqa: BLE001
            outs[tag] = e

    threads = [threading.Thread(target=go, args=("ok", qv, qi)),
               threading.Thread(target=go, args=("wide", wide, None))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert outs["ok"][0] == "d2"
    assert outs["wide"] == searcher.search_run(["w"], wide, None)[0]["w"]
    assert batcher.batches_run == 0  # no shared batch was run


def test_micro_batcher_concurrent_stress_matches_direct(rng):
    packed = _packed(rng, 64, "d")
    searcher = _searcher(packed, topk=4, theta=0.0, query_batch=8)
    reqs = []
    for i in range(20):
        rows = rng.integers(0, 64, int(rng.integers(1, 5)))
        reqs.append(([f"r{i}:{j}" for j in range(len(rows))],
                     *_q(packed, rows)))
    want = {}
    for qids, qv, qi in reqs:
        r, _ = searcher.search_run(qids, qv, qi)
        want[qids[0]] = {q: r[q] for q in qids}
    batcher = MicroBatcher(searcher, window_ms=10.0)

    def one(req):
        qids, qv, qi = req
        r, s = batcher.search(qids, qv, qi)
        assert set(r) == set(qids) and all(len(s[q]) == 4 for q in qids)
        return qids[0], {q: r[q] for q in qids}

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            got = dict(ex.map(one, reqs))
    finally:
        sys.setswitchinterval(old)
    assert got == want
    assert batcher.queries_run == sum(len(r[0]) for r in reqs)


def test_micro_batcher_overflow_request_carries_to_next_pool(rng):
    packed = _packed(rng, 32, "d")
    batcher = MicroBatcher(_searcher(packed, topk=3, theta=0.0,
                                     query_batch=4), window_ms=500.0)
    results = {}

    def one(name, rows):
        results[name] = batcher.search(
            [f"{name}{j}" for j in range(len(rows))], *_q(packed, rows))[0]

    ta = threading.Thread(target=one, args=("a", [0, 1, 2]))
    ta.start()
    time.sleep(0.1)  # "a" is pulled first
    tb = threading.Thread(target=one, args=("b", [3, 4, 5]))
    tb.start()
    ta.join(timeout=60)
    tb.join(timeout=60)
    assert batcher.batches_run == 2
    assert batcher.max_batch_seen <= 4
    for j in range(3):
        assert results["a"][f"a{j}"][0] == f"d{j}"
        assert results["b"][f"b{j}"][0] == f"d{j + 3}"


@pytest.mark.parametrize("micro_batch_ms", [0.0, 5.0])
def test_validate_rejects_duplicate_qids(rng, micro_batch_ms):
    packed = _packed(rng, 16, "d")
    service = SearchService(_searcher(packed, topk=3, theta=0.0),
                            micro_batch_ms=micro_batch_ms)
    qv, qi = _q(packed, [0, 1])
    with pytest.raises(ValueError, match="duplicate qids"):
        service.search({"values": qv.tolist(), "indices": qi.tolist(),
                        "qids": ["q", "q"]})


class SlowSearcher:
    """Stub searcher holding the worker for 0.15 s a pool."""

    config = SimpleNamespace(query_batch=1, mode="gip", theta=0.0, topk=1)
    index = SimpleNamespace(num_rows=1, dim=12, lex_dim=12)

    def search_run(self, qids, values, indices):
        time.sleep(0.15)
        return ({q: ["d0"] for q in qids}, {q: [1.0] for q in qids})


def test_bounded_ingress_queue_sheds_with_503():
    service = SearchService(SlowSearcher(), micro_batch_ms=1.0,
                            max_pending=1)
    codes, lock = [], threading.Lock()

    def one(port):
        code, body, retry = _post_code(port, "/search",
                                       {"values": [[0.0] * 12],
                                        "qids": ["q"]})
        if code == 200:
            assert body["results"]["q"] == ["d0"]
        else:
            assert code == 503 and retry == "1"
            assert body["error"].startswith("overloaded")
        with lock:
            codes.append(code)

    with running(service) as port:
        threads = [threading.Thread(target=one, args=(port,))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert len(codes) == 8
    assert codes.count(200) >= 1 and codes.count(503) >= 1
    stats = service.stats()
    assert stats["rejects"] == codes.count(503)
    assert stats["max_pending"] == 1


def test_close_finishes_the_pool_in_flight_and_fails_the_queued():
    """``SearchService.close`` stops the micro-batcher's worker: the pool
    it runs finishes, the requests still queued fail, and the thread (and
    with it the searchers it held) is gone."""
    entered, release = threading.Event(), threading.Event()

    class Gated(SlowSearcher):
        def search_run(self, qids, values, indices):
            entered.set()
            release.wait(10)
            return ({q: ["d0"] for q in qids}, {q: [1.0] for q in qids})

    service = SearchService(Gated(), micro_batch_ms=1.0)
    batcher = service.batcher
    got = {}

    def one(i):
        try:
            got[i] = batcher.search([f"q{i}"], np.zeros((1, 12), np.float32),
                                    None)
        except RuntimeError as e:
            got[i] = str(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    threads[0].start()
    assert entered.wait(10)  # the first pool is in flight
    for t in threads[1:]:
        t.start()
    deadline = time.monotonic() + 10
    while batcher._q.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    closer = threading.Thread(target=service.close)
    closer.start()
    while not batcher._closed and time.monotonic() < deadline:
        time.sleep(0.01)
    release.set()
    for t in (closer, *threads):
        t.join(timeout=10)
        assert not t.is_alive()
    assert not batcher._worker.is_alive() and batcher.searcher is None
    assert got[0] == ({"q0": ["d0"]}, {"q0": [1.0]})
    assert got[1] == got[2] == "the service is stopping"


def _reload_service(old, micro_batch_ms=0.0, small=False, loader=_loader,
                    token=None):
    idx = _device(old)
    cfg = dict(topk=5, theta=0.0, query_batch=8)
    return SearchService(
        _searcher(idx, **cfg), micro_batch_ms=micro_batch_ms,
        small_searcher=(_searcher(idx, **{**cfg, "query_batch": 2})
                        if small else None),
        index_loader=loader, reload_token=token)


@pytest.mark.parametrize("micro_batch_ms,small,free_first", [
    (0.0, False, False), (0.0, False, True), (5.0, True, False),
    (5.0, True, True)])
def test_admin_reload_swaps_index_without_restart(rng, tmp_path,
                                                  micro_batch_ms, small,
                                                  free_first):
    """Rankings come from the new corpus afterwards on every route, /stats
    shows the new row count, and the search configs carry over."""
    old, new = _packed(rng, 32, "old"), _packed(rng, 48, "new")
    path = str(tmp_path / "new.npz")
    new.save(path)
    service = _reload_service(old, micro_batch_ms, small)
    r, _ = service._run(["q0"], *_q(old, [0]))
    assert r["q0"][0] == "old0"
    out = service.reload({"index_path": path, "free_first": free_first})
    assert out == {"status": "ok", "rows": 48, "index_path": path,
                   "reloads": 1, "free_first": free_first}
    assert service.stats()["rows"] == 48 and service.stats()["reloads"] == 1
    r, _ = service._run(["q0"], *_q(new, [0]))  # low-latency when small
    assert r["q0"][0] == "new0" and all(d.startswith("new") for d in r["q0"])
    r, _ = service._run(["a", "b", "c"], *_q(new, [1, 2, 3]))
    assert r["a"][0] == "new1"
    if small:
        assert service.batcher.small.config.query_batch == 2
        assert service.batcher.small.index is service.searcher.index


def test_admin_reload_disabled_is_an_error(rng):
    service = SearchService(_searcher(_packed(rng, 8, "d"), topk=3))
    with pytest.raises(ValueError, match="--allow-reload"):
        service.reload({"index_path": "/nonexistent.npz"})
    with running(service, threaded=False) as port:
        code, body, _ = _post_code(port, "/admin/reload",
                                   {"index_path": "x"})
    assert code == 400 and "allow-reload" in body["error"]


def test_admin_reload_under_concurrent_load_never_mixes_indexes(rng,
                                                               tmp_path):
    old, new = _packed(rng, 32, "old"), _packed(rng, 32, "new")
    path = str(tmp_path / "new.npz")
    new.save(path)
    service = _reload_service(old, micro_batch_ms=2.0)
    qv, qi = _q(old, [0])
    service._run(["warm"], qv, qi)
    stop = threading.Event()
    bad, responses = [], []

    def client(tag):
        k = 0
        while not stop.is_set():
            r, _ = service._run([f"{tag}:{k}"], qv, qi)
            tags = {d[:3] for d in r[f"{tag}:{k}"]}
            responses.append(tags)
            if len(tags) != 1:
                bad.append(tags)
            k += 1

    def wait_for(tags):
        t0 = time.time()
        while tags not in responses[-8:]:
            assert time.time() - t0 < 30, f"no {tags} response"
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    wait_for({"old"})
    service.reload({"index_path": path})
    wait_for({"new"})  # clients run on after the swap
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not bad, f"responses mixed indexes: {bad[:3]}"
    r, _ = service._run(["post"], qv, qi)
    assert all(d.startswith("new") for d in r["post"])


def test_admin_reload_free_first_frees_before_loading(rng, tmp_path):
    """Every reference to the old index drops BEFORE the new one loads, and
    a request that arrives while the worker is parked lands on the new
    index."""
    old, new = _packed(rng, 32, "old"), _packed(rng, 32, "new")
    path = str(tmp_path / "new.npz")
    new.save(path)
    idx = _device(old)
    old_ref = weakref.ref(idx)
    service = SearchService(_searcher(idx, topk=5, theta=0.0, query_batch=8),
                            micro_batch_ms=2.0)
    del idx
    assert service._run(["q0"], *_q(old, [0]))[0]["q0"][0] == "old0"
    released, during = [], {}
    in_loader, fired = threading.Event(), threading.Event()

    def gated_loader(p):
        gc.collect()
        released.append(old_ref() is None)
        in_loader.set()
        assert fired.wait(timeout=30)
        time.sleep(0.2)  # the client's request lands in the queue
        return _loader(p)

    service.index_loader = gated_loader

    def late_client():
        assert in_loader.wait(timeout=30)
        fired.set()
        during["top1"] = service._run(["late"], *_q(new, [0]))[0]["late"][0]

    t = threading.Thread(target=late_client)
    t.start()
    out = service.reload({"index_path": path, "free_first": True})
    t.join(timeout=60)
    assert out["free_first"] is True and out["rows"] == 32
    assert released == [True], "the old index must be freed before loading"
    assert during["top1"] == "new0"


def test_admin_reload_free_first_failure_drains_and_recovers(rng, tmp_path):
    old, new = _packed(rng, 32, "old"), _packed(rng, 32, "new")
    path = str(tmp_path / "new.npz")
    new.save(path)
    service = _reload_service(old, micro_batch_ms=2.0)
    qv, qi = _q(old, [0])
    service._run(["warm"], qv, qi)
    with pytest.raises(FileNotFoundError):
        service.reload({"index_path": str(tmp_path / "missing.npz"),
                        "free_first": True})
    with pytest.raises(ValueError, match="no index loaded"):
        service._run(["q"], qv, qi)
    assert service.stats() == {"reloading": True, "reloads": 0}
    with running(service) as port:
        assert _get(port, "/healthz") == {"status": "reloading"}
    out = service.reload({"index_path": path, "free_first": True})
    assert out["rows"] == 32
    assert service._run(["q0"], *_q(new, [0]))[0]["q0"][0] == "new0"
    assert service.batcher.small is None


def test_admin_reload_token_required(rng, tmp_path):
    old, new = _packed(rng, 16, "old"), _packed(rng, 16, "new")
    path = str(tmp_path / "new.npz")
    new.save(path)
    service = _reload_service(old, token="s3cret")
    with running(service, threaded=False) as port:
        for headers in ({}, {"X-Reload-Token": "wrong"}):
            code, body, _ = _post_code(port, "/admin/reload",
                                       {"index_path": path}, headers)
            assert code == 403 and "X-Reload-Token" in body["error"]
        assert service.reloads == 0
        out = _post(port, "/admin/reload", {"index_path": path},
                    {"X-Reload-Token": "s3cret"})
    assert out["rows"] == 16 and service.reloads == 1


def test_listen_backlog_covers_client_bursts():
    import inspect

    assert serve_mod._PlainServer.request_queue_size >= 256
    assert serve_mod._ThreadingServer.request_queue_size >= 256
    src = inspect.getsource(serve_mod.serve_service)
    assert "_ThreadingServer" in src and "_PlainServer" in src


def test_serve_client_tool_runs_unchanged(rng, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "serve_client", os.path.join(ROOT, "tools", "serve_client.py"))
    client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(client)
    packed = _packed(rng, 16, "d")
    service = SearchService(_searcher(packed, topk=3, theta=0.0,
                                      query_batch=4))
    qv, qi = _q(packed, [0, 1])
    np.savez(tmp_path / "q.npz", values=qv, indices=qi)
    (tmp_path / "qids.json").write_text(json.dumps(["a", "b"]))
    with running(service) as port:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            client.main(["stats", "--port", str(port)])
        assert json.loads(buf.getvalue())["rows"] == 16
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            client.main(["search", "--port", str(port), "--values-npz",
                         str(tmp_path / "q.npz"), "--qids-json",
                         str(tmp_path / "qids.json")])
    out = json.loads(buf.getvalue())
    assert out["results"]["a"][0] == "d0" and out["results"]["b"][0] == "d1"


# ------------------------------------------------------------ the verb --


def _wait_healthy(port, proc=None, timeout=120):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"serve exited early: {proc.returncode}")
        try:
            return _get(port, "/healthz")
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.1)
    raise AssertionError("the service did not come up")


def test_serve_verb_in_process_matches_reference(tmp_path, monkeypatch):
    """``serve --device cpu`` with ``--query-encoder`` (a stub tokenizer,
    random tiny weights): /healthz, /stats, /search, /search_text and
    /admin/reload; its rankings equal the reference service's over the same
    index and queries."""
    rng = np.random.default_rng(3)
    old, new = _packed(rng, 40, "old", dim=16, lex=12), \
        _packed(rng, 24, "new", dim=16, lex=12)
    old_path, new_path = str(tmp_path / "old.npz"), str(tmp_path / "new.npz")
    old.save(old_path)
    new.save(new_path)
    servers = []

    class Recorded(serve_mod._ThreadingServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            servers.append(self)

    monkeypatch.setattr(serve_mod, "_ThreadingServer", Recorded)
    monkeypatch.setattr(tcli, "_load_tokenizer", lambda path: FakeTokenizer())
    port = _free_port()
    argv = ["serve", "--index-path", old_path, "--device", "cpu",
            "--port", str(port), "--topk", "6", "--theta", "0.0",
            "--query-batch", "4", "--micro-batch-ms", "2",
            "--low-latency-batch", "2", "--max-pending", "16",
            "--allow-reload", "--reload-token", "tok", "--query-encoder",
            "--tokenizer", "stub", "--tiny", "--tiny-vocab", "1024",
            "--model", "dhr", "--add-pooler", "--projection-dim", "4",
            "--dlr-out-dim", "12", "--remove-dims", "64",
            "--cls-token-id", "1", "--sep-token-id", "2", "--q-max-len", "8"]
    t = threading.Thread(target=tcli.main, args=(argv,), daemon=True)
    t.start()
    try:
        assert _wait_healthy(port) == {"status": "ok", "rows": 40}
        ref = JSearchService(
            JSearcher(JDeviceIndex.from_packed(JPackedIndex.load(old_path)),
                      JSearchConfig(topk=6, theta=0.0, query_batch=4)))
        qv = (rng.random((3, 16)) + 0.05).astype(np.float32)
        qi = rng.integers(0, 3, (3, 12)).astype(np.int32)
        p = {"values": qv.tolist(), "indices": qi.tolist(),
             "qids": ["a", "b", "c"]}
        _assert_same_results(_post(port, "/search", p), ref.search(p))
        stats = _get(port, "/stats")
        assert stats["rows"] == 40 and stats["low_latency_batch"] == 2
        assert stats["max_pending"] == 16 and stats["reloads"] == 0
        text = _post(port, "/search_text", {"queries": ["topic one",
                                                        "other words"]})
        assert set(text["results"]) == {"0", "1"}
        assert all(len(v) == 6 for v in text["results"].values())
        code, _, _ = _post_code(port, "/admin/reload",
                                {"index_path": new_path})
        assert code == 403
        out = _post(port, "/admin/reload", {"index_path": new_path,
                                            "free_first": True},
                    {"X-Reload-Token": "tok"})
        assert out["rows"] == 24
        ref = JSearchService(
            JSearcher(JDeviceIndex.from_packed(JPackedIndex.load(new_path)),
                      JSearchConfig(topk=6, theta=0.0, query_batch=4)))
        _assert_same_results(_post(port, "/search", p), ref.search(p))
    finally:
        for s in servers:
            s.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


def test_serve_verb_process_serves_reloads_and_stops_on_sigint(tmp_path):
    """The verb as a process: ``tools/serve_client.py`` against it, a
    reload, and a clean exit (status 0) on SIGINT."""
    rng = np.random.default_rng(4)
    old, new = _packed(rng, 20, "old"), _packed(rng, 10, "new")
    old.save(str(tmp_path / "old.npz"))
    new.save(str(tmp_path / "new.npz"))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dhr_tpu_torch", "serve", "--index-path",
         str(tmp_path / "old.npz"), "--device", "cpu", "--port", str(port),
         "--topk", "3", "--theta", "0", "--micro-batch-ms", "2",
         "--low-latency-batch", "2", "--allow-reload"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        assert _wait_healthy(port, proc) == {"status": "ok", "rows": 20}
        qv, qi = _q(new, [0, 1])
        np.savez(tmp_path / "q.npz", values=qv, indices=qi)
        client = [sys.executable, os.path.join(ROOT, "tools",
                                               "serve_client.py")]
        out = subprocess.run(client + ["stats", "--port", str(port)],
                             capture_output=True, text=True, timeout=60,
                             check=True)
        assert json.loads(out.stdout)["rows"] == 20
        _post(port, "/admin/reload",
              {"index_path": str(tmp_path / "new.npz")})
        out = subprocess.run(client + ["search", "--port", str(port),
                                       "--values-npz",
                                       str(tmp_path / "q.npz")],
                             capture_output=True, text=True, timeout=60,
                             check=True)
        res = json.loads(out.stdout)["results"]
        assert res["0"][0] == "new0" and res["1"][0] == "new1"
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            _, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0, err[-2000:]
    assert "interrupted; stopping" in err


def test_serve_verb_refuses_unported_flags_and_missing_tokenizer(
        tmp_path, monkeypatch):
    _packed(np.random.default_rng(0), 4, "d").save(str(tmp_path / "i.npz"))
    base = ["serve", "--index-path", str(tmp_path / "i.npz"), "--device",
            "cpu"]
    with pytest.raises(SystemExit):
        tcli.main(base + ["--candidate-recall"])
    # sharding is ported, but several cards need a launcher
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="torchrun"):
        tcli.main(base[:-2] + ["--shard-over-devices"])
    with pytest.raises(SystemExit, match="--tokenizer"):
        tcli.main(base + ["--query-encoder", "--tiny"])


def test_info_verb_reports_the_runtime(capsys):
    tcli.main(["info"])
    out = json.loads(capsys.readouterr().out)
    assert out["native_runtime"] is True
    assert out["native_so"].endswith("libdhr_torch_native.so")
    assert out["cuda_available"] == torch.cuda.is_available()
    assert set(out["kernels_built"]) == {"partial_gip", "rerank_gip",
                                         "gip_candidates", "lexical_pool",
                                         "moe_combine", "mla_attention",
                                         "kda_scan", "ssd_scan"}
    assert not any(k.startswith("jax") for k in out)
