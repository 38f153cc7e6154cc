"""``search`` and ``serve --shard-over-devices`` over two gloo ranks on the
CPU, each rank a ``python -m dhr_tpu_torch`` process with torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and a file
rendezvous (``--dist-init-method``).

- search: the sharded run's TREC file equals the one-process run's, rank 0
  alone writes it and the ``DHR_TIMING`` line;
- serve: rank 0 answers ``/search`` with the one-process ``search_run``'s
  results, reports ``sharded_over: 2``, reloads a second index (the
  follower loads its shard too), and both ranks exit 0 on SIGINT to rank 0;
- with several visible cards and no launcher the flag fails, naming
  ``torchrun --nproc-per-node``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from dhr_tpu_torch.cli import main as tcli
from dhr_tpu_torch.retrieval import (
    DeviceIndex, PackedIndex, SearchConfig, Searcher, read_run)
from torch_parallel_util import wait_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LEX, CLS, B = 301, 16, 4, 6
SEARCH = ["--theta", "0.3", "--rerank", "--agip-topk", "40", "--topk", "10",
          "--exact-candidates", "--no-candidate-bf16", "--query-batch", "4"]


def _write(tmp, seed, n, name):
    rng = np.random.default_rng(seed)
    e = rng.exponential(size=(n, LEX))
    lex = np.where(rng.random((n, LEX)) < 0.3, 0.1 + 0.35 * e, 0.05 * e)
    values = np.concatenate([lex, 0.3 * rng.standard_normal((n, CLS))],
                            1).astype(np.float16)
    packed = PackedIndex(values, rng.integers(0, 3, (n, LEX)).astype(
        np.uint8), np.asarray([f"{name}{i}" for i in range(n)], dtype=object),
        LEX)
    path = os.path.join(tmp, f"{name}.npz")
    packed.save(path)
    return packed, path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pcli"))
    packed, index = _write(tmp, 0, N, "p")
    packed2, index2 = _write(tmp, 1, N - 100, "r")
    rng = np.random.default_rng(2)
    qv = np.concatenate([0.2 + 0.3 * rng.exponential(size=(B, LEX)),
                         0.3 * rng.standard_normal((B, CLS))],
                        1).astype(np.float32)
    qi = rng.integers(0, 3, (B, LEX)).astype(np.int32)
    qpath = os.path.join(tmp, "q.npz")
    np.savez(qpath, values=qv, indices=qi)
    qids = [f"q{i}" for i in range(B)]
    with open(qpath + ".qids.json", "w") as f:
        json.dump(qids, f)
    return SimpleNamespace(tmp=tmp, packed=packed, index=index,
                           packed2=packed2, index2=index2, qpath=qpath,
                           qv=qv, qi=qi, qids=qids)


def _rank_env(rank, world):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "GROUP_RANK")}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return env


def _spawn(argvs, init):
    """One ``python -m dhr_tpu_torch`` process a rank (``argvs[r]``), its
    stdout and stderr written to files beside the rendezvous file (no pipe
    to drain while the others wait)."""
    base = init[len("file://"):]
    procs = []
    for r, argv in enumerate(argvs):
        logs = (f"{base}.rank{r}.out", f"{base}.rank{r}.err")
        with open(logs[0], "w") as out, open(logs[1], "w") as err:
            p = subprocess.Popen(
                [sys.executable, "-m", "dhr_tpu_torch", *argv,
                 "--dist-init-method", init], cwd=ROOT,
                env=_rank_env(r, len(argvs)), stdin=subprocess.DEVNULL,
                stdout=out, stderr=err)
        p.logs = logs
        procs.append(p)
    return procs


def _ranks(argv, world, init):
    return _spawn([[*argv, "--device", "cpu", "--shard-over-devices",
                    "--dist-backend", "gloo"]] * world, init)


def _wait(procs, timeout):
    """Every rank's ``(stdout, stderr)`` once all exit 0; raises with every
    rank's stderr tail when one exits non-zero or ``timeout`` passes."""
    wait_all(procs, [p.logs[1] for p in procs], timeout, "the ranks")
    outs = []
    for p in procs:
        with open(p.logs[0]) as out, open(p.logs[1]) as err:
            outs.append((out.read(), err.read()))
    return outs


@pytest.fixture(scope="module")
def sharded_search(files):
    out = os.path.join(files.tmp, "sharded.trec")
    procs = _ranks(["search", "--index-path", files.index, "--query-path",
                    files.qpath, "--output", out, *SEARCH], 2,
                   "file://" + os.path.join(files.tmp, "search.rdzv"))
    return out, _wait(procs, 240)


def test_sharded_search_writes_the_one_process_run(files, sharded_search):
    out, outs = sharded_search
    one = os.path.join(files.tmp, "one.trec")
    tcli.main(["search", "--index-path", files.index, "--query-path",
               files.qpath, "--output", one, "--device", "cpu", *SEARCH])
    with open(out) as f, open(one) as g:
        got, want = f.read().splitlines(), g.read().splitlines()
    assert len(got) == B * 10
    assert [ln.split()[:4] for ln in got] == [ln.split()[:4] for ln in want]
    np.testing.assert_allclose([float(ln.split()[4]) for ln in got],
                               [float(ln.split()[4]) for ln in want],
                               rtol=1e-6)
    assert read_run(out).keys() == set(files.qids)


def test_rank0_alone_reports(sharded_search):
    _, outs = sharded_search
    timing = [[ln for ln in err.splitlines() if ln.startswith("DHR_TIMING")]
              for _, err in outs]
    assert len(timing[0]) == 1 and timing[1] == []
    assert json.loads(timing[0][0].split(" ", 1)[1])["shards"] == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _want(packed, files):
    cfg = SearchConfig(theta=0.3, rerank=True, agip_topk=40, topk=10,
                       approx_candidates=False, candidate_bf16=False,
                       query_batch=4)
    s = Searcher(DeviceIndex.from_packed(packed, device="cpu"), cfg,
                 device="cpu")
    return s.search_run(files.qids, files.qv, files.qi)


def _same(got, want):
    assert got["results"] == want[0]
    for q, w in want[1].items():
        np.testing.assert_allclose(got["scores"][q], w, rtol=1e-6)


@pytest.fixture(scope="module")
def served(files):
    """Rank 0 serves, rank 1 follows: searches before and after a reload,
    then SIGINT to rank 0."""
    port = _free_port()
    procs = _ranks(["serve", "--index-path", files.index, "--port",
                    str(port), "--micro-batch-ms", "2", "--allow-reload",
                    *SEARCH[:-2], "--query-batch", "4"], 2,
                   "file://" + os.path.join(files.tmp, "serve.rdzv"))
    got = {}
    try:
        deadline = time.time() + 180
        while True:
            try:
                got["health"] = _http(port, "/healthz")
                break
            except OSError:
                if time.time() > deadline or any(
                        p.poll() is not None for p in procs):
                    raise
                time.sleep(0.5)
        body = {"values": files.qv.tolist(), "indices": files.qi.tolist(),
                "qids": files.qids}
        got["before"] = _http(port, "/search", body)
        got["one"] = _http(port, "/search", {
            "values": files.qv[:1].tolist(), "indices": files.qi[:1].tolist(),
            "qids": files.qids[:1]})
        got["stats"] = _http(port, "/stats")
        got["reload"] = _http(port, "/admin/reload",
                              {"index_path": files.index2})
        got["after"] = _http(port, "/search", body)
        got["reload_free"] = _http(port, "/admin/reload",
                                   {"index_path": files.index,
                                    "free_first": True})
        got["back"] = _http(port, "/search", body)
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGINT)
    got["exit"] = _wait(procs, 120)
    return got


def test_sharded_serve_equals_search_run(files, served):
    want = _want(files.packed, files)
    _same(served["before"], want)
    _same(served["back"], want)
    assert served["one"]["results"]["q0"] == want[0]["q0"]
    assert served["stats"]["sharded_over"] == 2
    assert served["health"]["rows"] == N


def test_sharded_serve_reloads_on_every_rank(files, served):
    assert served["reload"]["rows"] == N - 100
    _same(served["after"], _want(files.packed2, files))


def test_sharded_serve_stops_every_rank(served):
    # _wait asserted both exit codes are 0 after SIGINT to rank 0 alone
    assert len(served["exit"]) == 2


def test_several_cards_without_a_launcher_fail(monkeypatch, files):
    import torch

    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        tcli.main(["search", "--index-path", files.index, "--query-path",
                   files.qpath, "--output", os.path.join(files.tmp, "x"),
                   "--shard-over-devices"])


def test_one_card_without_a_launcher_is_one_shard(monkeypatch, files):
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    out = os.path.join(files.tmp, "single.trec")
    tcli.main(["search", "--index-path", files.index, "--query-path",
               files.qpath, "--output", out, "--device", "cpu",
               "--shard-over-devices", *SEARCH])
    assert len(open(out).read().splitlines()) == B * 10


def test_config_file_accepts_shard_over_devices(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"shard_over_devices": True,
                               "dist_backend": "gloo"}))
    parser = tcli.build_parser()
    args = tcli._apply_config_file(parser.parse_args(
        ["search", "--index-path", "i", "--query-path", "q", "--output",
         "o", "--config", str(cfg)]), parser)
    assert args.shard_over_devices and args.dist_backend == "gloo"


def _train_files(tmp):
    from dhr_tpu_torch.data.examples import write_jsonl

    rng = np.random.default_rng(8)
    write_jsonl(os.path.join(tmp, "corpus.jsonl"), (
        {"text_id": f"d{i}", "text": rng.integers(64, 1024, rng.integers(
            3, 12)).tolist()} for i in range(40)))
    write_jsonl(os.path.join(tmp, "train.jsonl"), (
        {"query": rng.integers(64, 1024, 5).tolist(),
         "positive_pids": [f"d{int(rng.integers(40))}"],
         "negative_pids": [f"d{int(i)}" for i in rng.integers(0, 40, 5)]}
        for _ in range(12)))


def _train_argv(tmp, out):
    return ["train", "--tiny", "--add-pooler", "--dlr-out-dim", "96",
            "--remove-dims", "64", "--cls-token-id", "1", "--sep-token-id",
            "2", "--p-max-len", "16", "--q-max-len", "8", "--train-path",
            os.path.join(tmp, "train.jsonl"), "--corpus-path",
            os.path.join(tmp, "corpus.jsonl"), "--output-dir", out,
            "--batch-size", "4", "--train-n-passages", "3",
            "--warmup-steps", "1", "--num-epochs", "2", "--metrics-path",
            out + ".jsonl", "--log-steps", "1"]


@pytest.fixture(scope="module")
def trained(files):
    """``train`` under two gloo ranks (data-parallel, batch 4 = 2 a rank,
    dropout 0.1) and in one process."""
    tmp = os.path.join(files.tmp, "train")
    os.makedirs(tmp)
    _train_files(tmp)
    procs = _spawn([[*_train_argv(tmp, os.path.join(tmp, "dp")), "--device",
                     "cpu", "--dist-backend", "gloo"]] * 2,
                   "file://" + os.path.join(tmp, "train.rdzv"))
    outs = _wait(procs, 300)
    tcli.main([*_train_argv(tmp, os.path.join(tmp, "one")), "--device",
               "cpu"])
    return tmp, outs


def test_data_parallel_train_verb_equals_one_process(trained):
    import torch

    tmp, outs = trained

    def metrics(name):
        with open(os.path.join(tmp, f"{name}.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f]

    dp, one = metrics("dp"), metrics("one")
    assert len(dp) == len(one) == 6
    np.testing.assert_allclose(dp, one, rtol=1e-5)
    a = torch.load(os.path.join(tmp, "dp", "export", "pytorch_model.bin"))
    b = torch.load(os.path.join(tmp, "one", "export", "pytorch_model.bin"))
    assert a.keys() == b.keys()
    keys = [k for k in b if "attention.k_lin.bias" not in k
            and "attention.key.bias" not in k]
    diff = np.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys))
    norm = np.sqrt(sum(float((b[k] ** 2).sum()) for k in keys))
    assert diff / norm <= 1e-5
    # rank 0 alone reports
    timing = [[ln for ln in err.splitlines() if ln.startswith("DHR_TIMING")]
              for _, err in outs]
    assert len(timing[0]) == 1 and timing[1] == []
