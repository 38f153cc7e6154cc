"""Resident search service: the index lives on the GPU, queries over HTTP.

Port of ``dhr_tpu/serve.py``, with the same protocol (``tools/
serve_client.py`` speaks it):

- ``POST /search``       {"values": [[...]], "indices": [[...]] | null,
                          "qids": [...] (optional)}  ->
                         {"results": {qid: [docid...]}, "scores": {...}}
- ``POST /search_text``  {"queries": ["raw text", ...], "qids": [...]}
                         (needs a query encoder, ``serve
                         --query-encoder``): tokenize + encode + search in
                         one round trip
- ``GET /healthz``       {"status": "ok", "rows": N}
- ``GET /stats``         index and service counters, and the quantiles of
                         the recorder's ``serve.queue_wait`` and
                         ``serve.encode_lock_wait`` spans
- ``POST /admin/reload`` {"index_path": "...", "free_first": bool} (needs
                         ``serve --allow-reload``): load a new index and
                         swap it in without a restart (see
                         :meth:`SearchService.reload`)

Over a row-sharded index (``serve --shard-over-devices`` under torchrun)
rank 0 runs the HTTP front end and the micro-batcher; every other rank runs
:func:`follow`, which receives each search's queries, each reload and the
shutdown by broadcast from rank 0 (:class:`Lockstep`) and runs the sharded
search with it in lockstep.

Two execution modes:

- default: single-threaded server; each request runs the searcher directly
  (requests queue at the socket).
- ``micro_batch_ms > 0``: threaded server + one worker thread that owns
  the searcher and coalesces concurrent requests into one search batch (up
  to ``SearchConfig.query_batch`` queries, waiting at most the window for
  stragglers), so single-query requests share one pass of the kernels.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

import numpy as np
import torch

from dhr_tpu_torch.utils import profiling

logger = logging.getLogger("dhr_tpu_torch.serve")

# queue sentinel: wakes the MicroBatcher worker so a pending searcher swap
# applies promptly even with no traffic (never delivered to clients)
_SWAP_WAKE = object()


class ServiceOverloaded(Exception):
    """Raised when the bounded ingress queue is full; maps to HTTP 503."""


def _validate_queries(qids, values, indices):
    """Convert and shape-check one request; returns (qids, values,
    indices)."""
    qids = list(qids)
    values = np.asarray(values, np.float32)
    if values.ndim != 2 or len(qids) != values.shape[0]:
        raise ValueError(
            f"{len(qids)} qids for values of shape {values.shape}; "
            "need one (D,)-row per qid"
        )
    if len({str(q) for q in qids}) != len(qids):
        # later rows would silently overwrite earlier ones in the result
        # dict (and in uid pooling): fail the request at submit time
        raise ValueError("duplicate qids within one request")
    if indices is not None:
        indices = np.asarray(indices, np.int32)
        if indices.shape[0] != values.shape[0]:
            raise ValueError(
                f"indices rows {indices.shape[0]} != values rows "
                f"{values.shape[0]}"
            )
    return qids, values, indices


class MicroBatcher:
    """Coalesces concurrent search requests into one device batch.

    One worker thread owns the searcher (and so the GPU's search work): it
    pulls a request, waits up to ``window_ms`` for more until
    ``query_batch`` queries are pooled, runs ONE ``search_run``, and fans
    the results back per request.  Duplicate qids across pooled requests
    are disambiguated internally, so callers never see each other's rows.

    ``small_searcher`` (optional): a second Searcher over the SAME
    DeviceIndex at a small ``query_batch``; pools that fit it run there
    (the low-latency route, with its own counter).

    ``max_pending`` (>0) bounds the ingress queue: once ``max_pending``
    requests are waiting, further submits raise :class:`ServiceOverloaded`
    (HTTP 503 + ``Retry-After`` at the handler), so memory stays bounded
    and callers get a clean shed signal instead of unbounded latency.
    """

    def __init__(self, searcher, window_ms: float = 3.0,
                 small_searcher=None, max_pending: int = 0):
        self.searcher = searcher
        self.small = small_searcher
        self.small_batches_run = 0
        self.window = window_ms / 1000.0
        self.batches_run = 0
        self.queries_run = 0  # queries in those batches (mean pool size)
        self.max_batch_seen = 0
        self.rejects = 0
        self._reject_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._carry = None  # request pulled but too big for the last pool
        self._swap = None   # pending (searcher, small) set by swap()
        # pause/resume is one state machine under one condition variable:
        # paired Events race on back-to-back pause cycles (a stale parked
        # flag lets the next pause() return before the worker parks, and
        # clearing the resume flag can eat the next signal)
        self._state_cv = threading.Condition()
        self._state = "running"  # running | pause_requested | parked
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker after its pool in flight and wait for it; the
        requests still queued fail.  A worker left running at exit keeps
        its searchers, and a sharded index's process group with its
        threads, alive while the interpreter finalizes, which can abort
        the process ("terminate called without an active exception")."""
        with self._state_cv:
            self._closed = True
            self._state_cv.notify_all()
        try:
            self._q.put_nowait(_SWAP_WAKE)
        except queue.Full:
            pass  # the worker is busy; it stops before its next pool
        self._worker.join(timeout)

    def pause(self):
        """Park the worker between pools and drop its searcher references
        (the free-first reload: an index that fills the card has no room
        for load-then-swap).  Blocks until the worker has parked; while
        parked, requests queue (and shed via ``max_pending``).  Call
        :meth:`resume` with the new searchers to restart."""
        with self._state_cv:
            self._state = "pause_requested"
        try:
            self._q.put_nowait(_SWAP_WAKE)
        except queue.Full:
            pass
        with self._state_cv:
            while self._state != "parked":
                self._state_cv.wait()
        # a not-yet-applied load-then-swap pair is superseded by this
        # reload: drop it so its searchers (and index tensors) free too
        self._swap = None
        self.searcher = None
        self.small = None

    def resume(self, searcher, small_searcher=None):
        """Restart the parked worker on new searchers.  ``searcher=None``
        restarts it in drain mode: queued and future requests fail fast
        with "no index loaded" instead of hanging (the state after a failed
        free-first load; a later reload can still fix the service)."""
        self.searcher = searcher
        self.small = small_searcher
        with self._state_cv:
            self._state = "running"
            self._state_cv.notify_all()

    def swap(self, searcher, small_searcher=None):
        """Hand the worker a new searcher pair (index reload).

        The worker applies it between pools, so a batch never mixes
        indexes: the in-flight pool finishes on the old index and every
        later pool runs on the new one.  The old tensors free once the
        worker drops its reference.
        """
        self._swap = (searcher, small_searcher)
        try:
            self._q.put_nowait(_SWAP_WAKE)
        except queue.Full:
            pass  # the worker is busy; it swaps before its next pool

    def search(self, qids, values, indices):
        # validate and convert BEFORE pooling: a malformed request must fail
        # alone at submit time, never poison a coalesced pool or misalign
        # another client's rows
        qids, values, indices = _validate_queries(qids, values, indices)
        done = threading.Event()
        # the submit's time and the request's trace: the worker records the
        # request's ``serve.queue_wait`` as its pool starts
        req = profiling.current()
        slot: dict = {"queued": (time.perf_counter(),
                                 None if req is None else req.trace)}
        try:
            self._q.put_nowait((qids, values, indices, done, slot))
        except queue.Full:
            with self._reject_lock:
                self.rejects += 1
            raise ServiceOverloaded(
                f"{self._q.maxsize} requests already pending; retry later"
            ) from None
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["results"], slot["scores"]

    def _loop(self):
        while True:
            with self._state_cv:
                if self._state == "pause_requested":
                    self._state = "parked"
                    self._state_cv.notify_all()
                    while self._state == "parked" and not self._closed:
                        self._state_cv.wait()
                    continue
                if self._closed:
                    break
            if self._swap is not None:
                self.searcher, self.small = self._swap
                self._swap = None
            if self.searcher is None:
                # drain mode (failed free-first reload): requests fail
                # fast, never hang, and a later reload can recover
                if self._carry is not None:
                    item, self._carry = self._carry, None
                else:
                    item = self._q.get()
                    if item is _SWAP_WAKE:
                        continue
                _, _, _, done, slot = item
                slot["error"] = ValueError(
                    "no index loaded (a free_first reload failed); "
                    "POST /admin/reload again"
                )
                done.set()
                continue
            cap = self.searcher.config.query_batch
            if self._carry is not None:
                batch, self._carry = [self._carry], None
            else:
                item = self._q.get()
                if item is _SWAP_WAKE:
                    continue
                batch = [item]
            n = len(batch[0][0])
            deadline = time.perf_counter() + self.window
            while n < cap:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is _SWAP_WAKE:
                    continue  # a swap applies at the next pool, never mid-pool
                if n + len(item[0]) > cap:
                    # admitting it would take the pool past one search batch
                    # (and off the low-latency route): it leads the next pool
                    self._carry = item
                    break
                batch.append(item)
                n += len(item[0])
            for _, _, _, _, slot in batch:
                queued, trace = slot["queued"]
                profiling.record("serve.queue_wait", queued, trace=trace)
            try:
                self._run(batch)
            except BaseException as e:  # noqa: BLE001 - keep the worker alive
                for _, _, _, done, slot in batch:
                    if not done.is_set():
                        slot["error"] = e
                        done.set()
        self.searcher = self.small = self._swap = None
        left = [self._carry] if self._carry is not None else []
        self._carry = None
        while True:
            try:
                left.append(self._q.get_nowait())
            except queue.Empty:
                break
        for item in left:
            if item is not _SWAP_WAKE:
                item[4]["error"] = RuntimeError("the service is stopping")
                item[3].set()

    def _per_request(self, batch):
        for qids, values, indices, done, slot in batch:
            try:
                with profiling.span("serve.search_run"):
                    r, s = self.searcher.search_run(qids, values, indices)
                slot["results"], slot["scores"] = r, s
            except Exception as e:  # noqa: BLE001 - reported to its caller
                slot["error"] = e
            done.set()

    def _run(self, batch):
        # unique internal ids: request i's qid q becomes "i:q" (inputs were
        # validated in search(), so shapes line up per request)
        uids = [f"{i}:{q}" for i, (qids, *_) in enumerate(batch)
                for q in qids]
        idxs = [b[2] for b in batch]
        try:
            # mixed dense / lexical or mismatched-width requests cannot
            # share one batch: run each alone, so one request's shape never
            # fails another's
            mixed = any((x is None) != (idxs[0] is None) for x in idxs)
            widths = {b[1].shape[1] for b in batch}
            if mixed or len(widths) > 1:
                self._per_request(batch)
                return
            values = np.concatenate([b[1] for b in batch], axis=0)
            indices = None if idxs[0] is None else np.concatenate(idxs, axis=0)
            engine = self.searcher
            if (self.small is not None
                    and len(uids) <= self.small.config.query_batch):
                engine = self.small
                self.small_batches_run += 1
            with profiling.span("serve.search_run"):
                results, scores = engine.search_run(uids, values, indices)
            self.batches_run += 1
            self.queries_run += len(uids)
            self.max_batch_seen = max(self.max_batch_seen, len(uids))
        except Exception as e:  # noqa: BLE001 - reported to every caller
            for _, _, _, done, slot in batch:
                slot["error"] = e
                done.set()
            return
        for i, (qids, _, _, done, slot) in enumerate(batch):
            slot["results"] = {q: results[f"{i}:{q}"] for q in qids}
            slot["scores"] = {q: scores[f"{i}:{q}"] for q in qids}
            done.set()


class _LeadSearcher:
    """Rank 0's face of a row-sharded searcher: each ``search_run`` first
    broadcasts the queries (with its role and index generation) to the
    followers, then runs the collective search with them, under the
    lockstep's lock so two threads never interleave collectives."""

    def __init__(self, searcher, role: str, gen: int, lockstep: "Lockstep"):
        self._searcher = searcher
        self._role = role
        self._gen = gen
        self._lockstep = lockstep

    def __getattr__(self, name):
        return getattr(self._searcher, name)

    def search_run(self, qids, values, indices=None):
        with self._lockstep.lock:
            self._lockstep.send({
                "op": "search", "role": self._role, "gen": self._gen,
                "qids": list(qids), "values": np.asarray(values),
                "indices": None if indices is None else np.asarray(indices)})
            return self._searcher.search_run(qids, values, indices)


class Lockstep:
    """Rank 0's side of a sharded service: the broadcast channel to the
    followers, the lock that keeps rank 0's collectives in one order, and
    the index generation (each reload is a new one)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.gen = 0

    def send(self, msg: dict) -> None:
        from dhr_tpu_torch.parallel.collectives import broadcast_object

        broadcast_object(msg, src=0)

    def wrap(self, searcher, role: str):
        if searcher is None:
            return None
        return _LeadSearcher(searcher, role, self.gen, self)

    def reload(self, path: str, free_first: bool, load):
        """Announce a reload of ``path`` to the followers, run ``load()``
        here, and agree with every rank on the outcome: returns what
        ``load()`` returned, or raises when any rank failed (the followers
        then drop what they loaded).  Holds the lock throughout, so no
        search's collectives fall between the announcement and the
        agreement."""
        from dhr_tpu_torch.parallel.collectives import all_true

        with self.lock:
            self.gen += 1
            self.send({"op": "reload", "path": path,
                       "free_first": free_first, "gen": self.gen})
            try:
                result, err = load(), None
            except Exception as e:  # noqa: BLE001 - agreed on, re-raised
                result, err = None, e
            if not all_true(err is None):
                raise err or RuntimeError(
                    f"reload of {path} failed on another rank (see its log)")
            return result

    def stop(self) -> None:
        with self.lock:
            self.send({"op": "stop"})


def follow(searchers: dict, index_loader, make_searchers) -> None:
    """A follower rank's loop: run rank 0's searches on this rank's shard
    until rank 0 sends the shutdown.

    ``searchers``: ``{"main": Searcher, "small": Searcher or None}`` over
    the boot index; ``index_loader(path)`` loads this rank's shard of a new
    index and ``make_searchers(index)`` builds that pair over it.  A
    reload keeps the previous generation until rank 0's first search on
    the new one (load-then-swap: rank 0 may finish a pool on the old
    index), or drops it first (``free_first``).  A load that fails on any
    rank fails the reload on every rank (:meth:`Lockstep.reload`) and the
    loop goes on.  A search that fails here leaves this rank out of step
    with rank 0, so it raises: the process exits and the launcher ends the
    job."""
    from dhr_tpu_torch.parallel.collectives import all_true, broadcast_object

    gens = {0: searchers}
    while True:
        msg = broadcast_object(None, src=0)
        op = msg["op"]
        if op == "stop":
            return
        if op == "reload":
            if msg["free_first"]:
                gens.clear()
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            try:
                gens[msg["gen"]] = make_searchers(index_loader(msg["path"]))
            except Exception:  # noqa: BLE001 - agreed on with rank 0 below
                logger.exception("follower: reload of %s failed",
                                 msg["path"])
            if not all_true(msg["gen"] in gens):
                gens.pop(msg["gen"], None)
            continue
        for g in [g for g in gens if g < msg["gen"]]:
            del gens[g]
        gens[msg["gen"]][msg["role"]].search_run(
            msg["qids"], msg["values"], msg["indices"])


class SearchService:
    """Wraps a Searcher with a JSON request / response surface.

    ``query_encoder``: optional callable ``(list[str]) -> (values,
    indices or None)`` enabling ``/search_text``.  Handler threads call it
    one at a time (under a lock): the port's ``Encoder`` pipelines its
    copy-back and is not re-entrant.

    ``index_loader``: optional callable ``(path) -> DeviceIndex`` enabling
    ``POST /admin/reload``.

    ``lockstep``: rank 0's :class:`Lockstep` over a row-sharded index (the
    other ranks run :func:`follow`); the searchers are wrapped so every
    search, reload and the shutdown reach the followers.
    """

    def __init__(self, searcher, micro_batch_ms: float = 0.0,
                 small_searcher=None, query_encoder=None,
                 max_pending: int = 0, index_loader=None,
                 reload_token=None, lockstep: Lockstep | None = None):
        self.lockstep = lockstep
        if lockstep is not None:
            searcher = lockstep.wrap(searcher, "main")
            small_searcher = lockstep.wrap(small_searcher, "small")
        self.searcher = searcher
        self.query_encoder = query_encoder
        self.index_loader = index_loader
        self.reload_token = reload_token
        self.reloads = 0
        self._reload_lock = threading.Lock()
        self._encode_lock = threading.Lock()
        # config snapshots survive a failed free-first reload (searcher is
        # None then, but the corrective reload still needs the configs)
        self._last_cfg = None
        self._last_small_cfg = None
        self.batcher = (
            MicroBatcher(searcher, micro_batch_ms,
                         small_searcher=small_searcher,
                         max_pending=max_pending)
            if micro_batch_ms > 0 else None
        )

    def close(self) -> None:
        """Stop the micro-batcher's worker (:meth:`MicroBatcher.close`);
        the service takes no search after it."""
        if self.batcher is not None:
            self.batcher.close()

    def _run(self, qids, values, indices):
        if self.batcher is not None:
            return self.batcher.search(qids, values, indices)
        qids, values, indices = _validate_queries(qids, values, indices)
        if self.searcher is None:
            raise ValueError("no index loaded (a free_first reload "
                             "failed); POST /admin/reload again")
        with profiling.span("serve.search_run"):
            return self.searcher.search_run(qids, values, indices)

    def search(self, payload: dict) -> dict:
        with profiling.span("serve.request"):
            values = np.asarray(payload["values"], np.float32)
            indices = payload.get("indices")
            if indices is not None:
                indices = np.asarray(indices, np.int32)
            qids = payload.get("qids") or [str(i) for i in range(len(values))]
            results, scores = self._run(qids, values, indices)
        return {"results": results, "scores": scores}

    def search_text(self, payload: dict) -> dict:
        if self.query_encoder is None:
            raise ValueError(
                "text search needs a query encoder (serve --query-encoder)"
            )
        queries = payload["queries"]
        qids = payload.get("qids") or [str(i) for i in range(len(queries))]
        with profiling.span("serve.request"):
            with profiling.span("serve.encode_lock_wait"):
                self._encode_lock.acquire()
            try:
                with profiling.span("serve.encode"):
                    values, indices = self.query_encoder(list(queries))
            finally:
                self._encode_lock.release()
            results, scores = self._run(qids, values, indices)
        return {"results": results, "scores": scores}

    def reload(self, payload: dict) -> dict:
        """Swap in a freshly loaded index without restarting the service.

        Default (load-then-swap): the new index loads while the old one
        keeps serving, so the card holds both during the overlap.  The swap
        is atomic per pool: in-flight requests finish on the old index,
        every later request runs on the new one, and the old tensors free
        when the last reference drops.

        ``free_first``: park the worker between pools, drop every reference
        to the old searchers, collect and return the cached blocks to the
        device (``torch.cuda.empty_cache``), then load: for an index too
        large to hold twice.  Requests queue during the gap (shedding via
        ``max_pending``).  A failed load leaves the service in drain mode
        (requests fail fast) until a later reload succeeds.

        Search configs (theta, pools, batch sizes) carry over unchanged.
        """
        if self.index_loader is None:
            raise ValueError(
                "index reload is disabled (start with serve --allow-reload)"
            )
        from dhr_tpu_torch.retrieval import Searcher

        path = payload["index_path"]
        free_first = bool(payload.get("free_first"))
        with self._reload_lock:  # one reload at a time; uploads are big
            if self.searcher is not None:
                self._last_cfg = dataclasses.replace(self.searcher.config)
            if self.batcher is not None and self.batcher.small is not None:
                self._last_small_cfg = dataclasses.replace(
                    self.batcher.small.config)
            cfg, small_cfg = self._last_cfg, self._last_small_cfg
            if cfg is None:
                raise ValueError("service has no search config to reuse")
            if free_first:
                if self.batcher is not None:
                    self.batcher.pause()
                self.searcher = None
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()

            def load():
                index = self.index_loader(path)
                new = Searcher(index, cfg, device=index.device)
                new_small = (Searcher(index, small_cfg, device=index.device)
                             if small_cfg else None)
                if self.lockstep is not None:
                    new = self.lockstep.wrap(new, "main")
                    new_small = self.lockstep.wrap(new_small, "small")
                return index, new, new_small

            try:
                index, new, new_small = (
                    load() if self.lockstep is None
                    else self.lockstep.reload(path, free_first, load))
            except BaseException:
                if free_first:
                    # the old index is already gone: restart the worker in
                    # drain mode so queued / future requests fail fast
                    # instead of hanging; a later reload can recover
                    if self.batcher is not None:
                        self.batcher.resume(None, None)
                    self.searcher = None
                raise
            if self.batcher is not None:
                if free_first:
                    self.batcher.resume(new, new_small)
                else:
                    self.batcher.swap(new, new_small)
            self.searcher = new
            self.reloads += 1
            logger.info("reloaded index from %s (%d rows, free_first=%s)",
                        path, index.num_rows, free_first)
            return {"status": "ok", "rows": int(index.num_rows),
                    "index_path": path, "reloads": self.reloads,
                    "free_first": free_first}

    def stats(self) -> dict:
        searcher = self.searcher
        if searcher is None:  # mid free-first reload (threaded server)
            return {"reloading": True, "reloads": self.reloads}
        idx = searcher.index
        out = {
            "rows": int(idx.num_rows),
            "dim": int(idx.dim),
            "lex_dim": int(idx.lex_dim),
            "sharded_over": int(getattr(idx, "shards", 1)),
            "mode": searcher.config.mode,
            "theta": searcher.config.theta,
            "topk": searcher.config.topk,
        }
        batcher = self.batcher
        small = batcher.small if batcher is not None else None
        if getattr(searcher.config, "escalate_pool", 0):
            out["escalate_pool"] = searcher.config.escalate_pool
            # the low-latency route serves single-query traffic alone: its
            # escalations count too
            out["escalated_queries"] = searcher.escalated_queries + (
                small.escalated_queries if small is not None else 0)
        if self.index_loader is not None:
            out["reloads"] = self.reloads
        if self.query_encoder is not None:
            out["encode_lock_wait_ms"] = _quantiles_ms(
                "serve.encode_lock_wait")
        if batcher is not None:
            out["micro_batches_run"] = batcher.batches_run
            out["micro_batch_max_queries"] = batcher.max_batch_seen
            out["queue_depth"] = batcher._q.qsize()
            out["max_pending"] = int(batcher._q.maxsize)
            out["rejects"] = batcher.rejects
            out["queue_wait_ms"] = _quantiles_ms("serve.queue_wait")
            if small is not None:
                out["low_latency_batches_run"] = batcher.small_batches_run
                out["low_latency_batch"] = int(small.config.query_batch)
        return out


def _quantiles_ms(name: str) -> dict:
    """``{n, p50, p95}`` of the host ms of the recorder's kept ``name``
    spans (None without any)."""
    ms = [s.host_ms for s in profiling.spans(name)]
    if not ms:
        return {"n": 0, "p50": None, "p95": None}
    p50, p95 = np.percentile(ms, [50, 95])
    return {"n": len(ms), "p50": float(p50), "p95": float(p95)}


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug(fmt, *args)

        def _reply(self, code: int, obj: dict, headers: dict | None = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                stats = service.stats()
                if stats.get("reloading"):
                    self._reply(200, {"status": "reloading"})
                else:
                    self._reply(200, {"status": "ok",
                                      "rows": stats["rows"]})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            fn = {"/search": service.search,
                  "/search_text": service.search_text,
                  "/admin/reload": service.reload}.get(self.path)
            if fn is None:
                self._reply(404, {"error": "unknown path"})
                return
            if self.path == "/admin/reload" and service.reload_token:
                if self.headers.get("X-Reload-Token") != \
                        service.reload_token:
                    self._reply(403, {"error": "bad or missing "
                                      "X-Reload-Token"})
                    return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                self._reply(200, fn(payload))
            except ServiceOverloaded as e:
                self._reply(503, {"error": f"overloaded: {e}"},
                            headers={"Retry-After": "1"})
            except Exception as e:  # noqa: BLE001 - report to the client
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(searcher, host: str = "127.0.0.1", port: int = 8080,
          micro_batch_ms: float = 0.0, small_searcher=None,
          query_encoder=None, max_pending: int = 0, index_loader=None,
          reload_token=None):
    """Blocking serve loop.

    ``micro_batch_ms > 0`` switches to the threaded server + worker
    coalescing (see :class:`MicroBatcher`).  ``small_searcher`` adds the
    low-latency route for pools that fit it.  ``query_encoder`` enables
    ``/search_text``.  ``max_pending`` bounds the ingress queue (excess
    requests get HTTP 503 + ``Retry-After``).  ``index_loader`` enables
    ``POST /admin/reload``; ``reload_token`` requires a matching
    ``X-Reload-Token`` header there — always set it on non-loopback binds.
    """
    service = SearchService(searcher, micro_batch_ms=micro_batch_ms,
                            small_searcher=small_searcher,
                            query_encoder=query_encoder,
                            max_pending=max_pending,
                            index_loader=index_loader,
                            reload_token=reload_token)
    # drop this frame's searcher references: serve_forever() returns only on
    # an interrupt, so anything pinned here could never be freed by a
    # free-first reload
    del searcher, small_searcher
    serve_service(service, host=host, port=port,
                  threaded=micro_batch_ms > 0)


class _PlainServer(HTTPServer):
    # socketserver's default listen backlog is 5; a burst of concurrent
    # clients overflows it and the kernel resets connections before the
    # handler sees them.  Raise it well past any sane client burst.
    request_queue_size = 1024


class _ThreadingServer(ThreadingHTTPServer):
    request_queue_size = 1024


def serve_service(service: SearchService, host: str = "127.0.0.1",
                  port: int = 8080, threaded: bool = False):
    """Blocking serve loop over an already-built :class:`SearchService`;
    returns after an interrupt (SIGINT), with the socket closed.

    The caller should drop its own searcher / index references after
    building the service (the service owns them, and a ``free_first``
    reload frees them): callers' stack frames outlive ``serve_forever``.
    """
    server_cls = _ThreadingServer if threaded else _PlainServer
    server = server_cls((host, port), make_handler(service))
    logger.info("serving %d rows on %s:%d (threaded=%s)",
                service.stats().get("rows", 0), host, port, threaded)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("interrupted; stopping")
    finally:
        server.server_close()
