"""One gloo rank of the parallel tests (tests/test_torch_parallel*.py).

    python tests/torch_parallel_worker.py TASK WORLD RANK INIT IN OUT

Joins a ``WORLD``-rank gloo group on the CPU through the ``INIT`` file
rendezvous, runs ``TASK`` on the pickled inputs ``IN`` and pickles this
rank's results to ``OUT``.  The tests spawn every rank of a group once per
module (see ``torch_parallel_util.run_ranks``) and assert on the results.
"""

from __future__ import annotations

import contextlib
import datetime
import inspect
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TASKS = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def _log(msg: str) -> None:
    """A timestamped line on this rank's stderr (the spawner keeps each
    rank's log and shows its tail when a group fails or hangs)."""
    rank = (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else "-")
    print(f"{datetime.datetime.now():%H:%M:%S.%f} rank {rank} {msg}",
          file=sys.stderr, flush=True)


class FunctionalCollectiveCalled(RuntimeError):
    pass


@contextlib.contextmanager
def no_functional_collectives():
    """Every entry point of ``torch.distributed._functional_collectives``
    raises inside: a DTensor redistribution (``full_tensor``,
    ``redistribute``, DTensor parallel styles), the kind of collective
    that crashes under gloo with CUDA tensors on the card, fails here on
    the CPU."""
    import torch.distributed._functional_collectives as funcol

    def refuse(name):
        def call(*args, **kwargs):
            raise FunctionalCollectiveCalled(
                f"functional collective {name} called on the TP path")
        return call

    saved = {n: f for n, f in vars(funcol).items()
             if inspect.isfunction(f) and f.__module__ == funcol.__name__
             and not n.startswith("_")
             and not n.endswith(("_backward", "_setup_context"))}
    for n in saved:
        setattr(funcol, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(funcol, n, f)


def _guard(sc):
    """The guard of a TP scenario, a no-op for the others."""
    return (no_functional_collectives() if sc["mesh"] == "tp"
            else contextlib.nullcontext())


def _guard_trips(model) -> bool:
    """True when, under the guard, ``full_tensor`` of a sharded parameter
    raises: the guard covers what a DTensor redistribution calls."""
    p = next(p for p in model.parameters() if type(p).__name__ == "DTensor")
    try:
        p.full_tensor()
    except FunctionalCollectiveCalled:
        return True
    return False


def _mesh(kind: str):
    from dhr_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    if kind == "hybrid":
        return make_hybrid_mesh(num_hosts=2)
    return make_mesh(axis="index")


@task
def search(inp):
    """Each scenario: a row-sharded index over the mesh, search and
    search_run (and calibrations where asked)."""
    from dhr_tpu_torch.retrieval import (
        DeviceIndex, PackedIndex, SearchConfig, Searcher, calibrate_pool)

    out = {}
    for name, sc in inp["scenarios"].items():
        _log(f"scenario {name} start")
        mesh = _mesh(sc.get("mesh", "index"))
        packed = PackedIndex(**sc["packed"])
        idx = DeviceIndex.from_packed(packed, layout=sc.get("layout", "both"),
                                      device="cpu", mesh=mesh)
        s = Searcher(idx, SearchConfig(**sc["cfg"]), device="cpu")
        scores, rows = s.search(sc["qv"], sc["qi"])
        escalated = s.escalated_queries
        run = s.search_run(sc["qids"], sc["qv"], sc["qi"])
        res = {"scores": scores, "rows": rows, "run": run,
               "shape": tuple(idx.values.shape if idx.values is not None
                              else idx.values_T.shape),
               "offset": idx.row_offset, "axes": idx.shard_axes,
               "escalated": escalated,
               "timing_shards": s.last_timing["shards"]}
        if sc.get("calibrate"):
            res["escalation"] = s.calibrate_escalation(sc["qv"], sc["qi"])
            rep = calibrate_pool(idx, SearchConfig(**sc["cfg"]), sc["qv"],
                                 sc["qi"], pools=(64, 32), passes=1)
            res["pool_overlap"] = {p: v["overlap_mean"]
                                   for p, v in rep["pools"].items()}
        out[name] = res
        _log(f"scenario {name} end")
    return out


@task
def serve_reload(inp):
    """A sharded service: rank 0 serves through a Lockstep, rank 1 follows.
    The loader of rank 1 alone fails on the path ``"bad"`` (a path missing
    on one host); rank 0 tries it load-then-swap and free-first, then
    reloads ``"second"``.  Returns rank 0's replies."""
    from dhr_tpu_torch.parallel import make_mesh
    from dhr_tpu_torch.retrieval import (
        DeviceIndex, PackedIndex, SearchConfig, Searcher)
    from dhr_tpu_torch.serve import Lockstep, SearchService, follow

    mesh = make_mesh(axis="index")
    rank = torch.distributed.get_rank()

    def loader(path):
        if path == "bad" and rank == 1:
            raise OSError("no index at this path on this host")
        packed = inp["packed"]["first" if path == "bad" else path]
        return DeviceIndex.from_packed(PackedIndex(**packed), device="cpu",
                                       mesh=mesh)

    def make(index):
        return {"main": Searcher(index, SearchConfig(**inp["cfg"]),
                                 device="cpu"), "small": None}

    pair = make(loader("first"))
    if rank:
        follow(pair, loader, make)
        return None
    lockstep = Lockstep()
    svc = SearchService(pair["main"], index_loader=loader, lockstep=lockstep)
    body = {"values": inp["qv"], "indices": inp["qi"], "qids": inp["qids"]}
    out = {"before": svc.search(body)}
    for free_first in (False, True):
        try:
            svc.reload({"index_path": "bad", "free_first": free_first})
            out[f"bad_free{free_first}"] = "ok"
        except Exception as e:  # noqa: BLE001 - the refusal is the result
            out[f"bad_free{free_first}"] = repr(e)
        try:
            out[f"search_free{free_first}"] = svc.search(body)
        except Exception as e:  # noqa: BLE001 - drain mode is the result
            out[f"search_free{free_first}"] = repr(e)
    out["good"] = svc.reload({"index_path": "second"})
    out["after"] = svc.search(body)
    lockstep.stop()
    return out


def _train_setup(sc, group_mesh=None):
    """(model, RetrieverConfig, LossConfig) of a train scenario."""
    from dhr_tpu_torch.models import (
        BiEncoder, EncoderConfig, RetrieverConfig, load_flax_params)
    from dhr_tpu_torch.train.step import LossConfig

    cfg = RetrieverConfig(encoder=EncoderConfig(dtype=torch.float32,
                                                **sc["enc"]), **sc["family"])
    model = load_flax_params(BiEncoder(cfg), sc["tree"])
    return model, cfg, LossConfig(**sc["loss"])


def _full(t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().clone().numpy()


def _train_mesh(kind):
    from dhr_tpu_torch.parallel import make_hybrid_mesh, make_mesh
    from dhr_tpu_torch.parallel.mesh import _device_mesh

    if kind == "data":
        return make_mesh(axis="data")
    if kind == "hybrid":
        return make_hybrid_mesh(inner_axis="data", num_hosts=2)
    if kind == "tp":  # (data, model) = (world / 2, 2)
        w = torch.distributed.get_world_size()
        return _device_mesh(np.arange(w).reshape(w // 2, 2),
                            ("data", "model"))
    raise ValueError(kind)


def _make_state(sc, mesh):
    from dhr_tpu_torch.train.driver import RunConfig, parallelize
    from dhr_tpu_torch.train.optimizer import OptimizerConfig
    from dhr_tpu_torch.train.state import TrainState

    model, cfg, loss_cfg = _train_setup(sc)
    group = parallelize(model, mesh, RunConfig(
        fsdp=sc.get("fsdp", False), fsdp_min_size=sc.get("min_size", 64)))
    teacher = None
    if sc.get("teacher"):
        from dhr_tpu_torch.models import (
            BiEncoder, EncoderConfig, RetrieverConfig, load_flax_params)

        tcfg = RetrieverConfig(encoder=EncoderConfig(
            dtype=torch.float32, **sc["enc"]), **sc["teacher"]["family"])
        teacher = load_flax_params(BiEncoder(tcfg), sc["teacher"]["tree"])
    state = TrainState.create(model, OptimizerConfig(**sc["opt"]),
                              data_group=group)
    return state, cfg, loss_cfg, teacher


def _step_fn(sc, state, cfg, loss_cfg, teacher):
    from dhr_tpu_torch.train import step as tstep

    if sc["step"] == "packed":
        return tstep.make_packed_train_step(state.model, cfg, loss_cfg)
    if sc["step"] == "grad_cache":
        return tstep.make_grad_cache_train_step(
            state.model, cfg, loss_cfg, q_chunks=2, p_chunks=2)
    return tstep.make_train_step(state.model, cfg, loss_cfg, teacher=teacher)


def _report(state, loss):
    return {"loss": float(loss),
            "grads": {n: _full(p.grad) for n, p in
                      state.model.named_parameters() if p.grad is not None},
            "params": {n: _full(p) for n, p in
                       state.model.named_parameters()},
            "sharded": sorted(n for n, p in state.model.named_parameters()
                              if type(p).__name__ == "DTensor")}


@task
def train(inp):
    """Each scenario: one (or, with ``ckpt``, a saved, restored and
    resumed) step of a sharded train state on this rank's rows.  A TP
    scenario runs its path under :func:`no_functional_collectives`."""
    from dhr_tpu_torch.parallel import shard_batch
    from dhr_tpu_torch.train.checkpoint import (
        restore_train_state, save_train_state)
    from dhr_tpu_torch.train.driver import data_axes

    out = {}
    for name, sc in inp["scenarios"].items():
        _log(f"scenario {name} start")
        mesh = _train_mesh(sc["mesh"])
        batches = [shard_batch(b, mesh, data_axes(mesh))
                   for b in sc["batches"]]
        with _guard(sc):
            state, cfg, loss_cfg, teacher = _make_state(sc, mesh)
            step = _step_fn(sc, state, cfg, loss_cfg, teacher)
            loss = step(state, batches[0], sc["seed"])
            trips = sc["mesh"] == "tp" and _guard_trips(state.model)
        res = {"first": _report(state, loss), "guard_trips": trips}
        if sc.get("ckpt"):
            with _guard(sc):
                save_train_state(sc["ckpt"], state)
                fresh, *_ = _make_state(sc, mesh)
                restore_train_state(sc["ckpt"], fresh)
                step = _step_fn(sc, fresh, cfg, loss_cfg, teacher)
                loss = step(fresh, batches[1], sc["seed"])
            res["resumed"] = _report(fresh, loss)
            res["step"] = fresh.step
        out[name] = res
        _log(f"scenario {name} end")
    return out


def _full_copy(tree):
    """A state dict's tensors whole (``full_tensor``), on the host."""
    if isinstance(tree, torch.Tensor):
        t = tree.full_tensor() if type(tree).__name__ == "DTensor" else tree
        return t.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _full_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_full_copy(v) for v in tree)
    return tree


def _ckpt_leg(sc, mesh, made):
    """From a fresh sharded state (``made``, :func:`_make_state`'s): a (clipped) step, each sharded
    gradient's c10d norm beside ``full_tensor``'s, the state's host copy
    beside ``full_tensor``'s, a save, the next step, and the same next
    step from a fresh state restored from the save.  The port's own calls
    run under the scenario's guard; the ``full_tensor`` references
    outside it."""
    from dhr_tpu_torch.parallel import shard_batch
    from dhr_tpu_torch.train.checkpoint import (
        _to_host, restore_train_state, save_train_state)
    from dhr_tpu_torch.train.driver import data_axes
    from dhr_tpu_torch.train.optimizer import _grad_norm

    state, cfg, loss_cfg, _ = made
    batches = [shard_batch(b, mesh, data_axes(mesh)) for b in sc["batches"]]
    parts = ("model", "optimizer")
    with _guard(sc):
        step = _step_fn(sc, state, cfg, loss_cfg, None)
        loss = step(state, batches[0], sc["seed"])
        norms = {n: float(_grad_norm(p.grad))
                 for n, p in state.model.named_parameters()
                 if type(p.grad).__name__ == "DTensor"}
        host = {part: _to_host(getattr(state, part).state_dict())
                for part in parts}
    out = {"first": _report(state, loss), "host_copy": host,
           "full_tensor_copy": {part: _full_copy(getattr(state, part)
                                                 .state_dict())
                                for part in parts}}
    out["grad_norms"] = {
        n: (norms[n], float(torch.linalg.vector_norm(p.grad.full_tensor())))
        for n, p in state.model.named_parameters() if n in norms}
    with _guard(sc):
        save_train_state(sc["ckpt"], state)
        out["next_loss"] = float(step(state, batches[1], sc["seed"]))
        fresh, *_ = _make_state(sc, mesh)
        restore_train_state(sc["ckpt"], fresh)
        step = _step_fn(sc, fresh, cfg, loss_cfg, None)
        out["resumed_step"] = fresh.step
        out["resumed_loss"] = float(step(fresh, batches[1], sc["seed"]))
    return out


@task
def fsdp_ckpt(inp):
    """c10d gathers of DTensors whose dims the ranks do not divide, against
    ``DTensor.full_tensor``; then :func:`_ckpt_leg` of an FSDP state over
    ``data`` and, given ``tp_scenario``, of a TP state over ``(data,
    model)`` under :func:`no_functional_collectives`."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from dhr_tpu_torch.parallel.collectives import gather_full
    from dhr_tpu_torch.parallel.mesh import _device_mesh

    w = torch.distributed.get_world_size()
    x = torch.randn(inp["rows"], inp["cols"],
                    generator=torch.Generator().manual_seed(0))
    layouts = [("1d", _train_mesh("data"), [Shard(0)]),
               ("1d", _train_mesh("data"), [Shard(1)])]
    if w == 4:
        grid = _device_mesh(np.arange(4).reshape(2, 2), ("a", "b"))
        layouts += [("2d", grid, [Shard(0), Shard(0)]),
                    ("2d", grid, [Shard(0), Shard(1)]),
                    ("2d", grid, [Replicate(), Shard(1)])]
    uneven = {}
    for name, mesh, placements in layouts:
        d = distribute_tensor(x, mesh, placements)
        key = f"{name} {placements}"
        uneven[key] = {"gathered": gather_full(d).numpy(),
                       "full_tensor": d.full_tensor().numpy(),
                       "local_rows": int(d.to_local().shape[0]),
                       "local_cols": int(d.to_local().shape[1])}
    out = {"uneven": uneven, "whole": x.numpy()}
    _log("uneven gathers done")

    sc = inp["scenario"]
    mesh = _train_mesh("data")
    made = _make_state(sc, mesh)
    state = made[0]
    # a foreach AdamW over FSDP's mix of DTensor shards and plain tensors
    # raises (the port's optimizer steps them one by one instead)
    kinds = {type(p).__name__ for p in state.params}
    mixed = torch.optim.AdamW(state.params, lr=0.0, foreach=True)
    for p in state.params:
        p.grad = torch.zeros_like(p)
    try:
        mixed.step()
        out["foreach_on_mixed_raises"] = False
    except RuntimeError as e:
        out["foreach_on_mixed_raises"] = "mixed" in str(e)
    state.zero_grad()
    out["param_kinds"] = sorted(kinds)
    out["foreach"] = state.optimizer.defaults["foreach"]
    out.update(_ckpt_leg(sc, mesh, made))
    _log("fsdp leg done")
    if inp.get("tp_scenario"):
        sc = inp["tp_scenario"]
        mesh = _train_mesh("tp")
        with _guard(sc):
            made = _make_state(sc, mesh)
        out["tp"] = _ckpt_leg(sc, mesh, made)
        _log("tp leg done")
    return out


@task
def encode(inp):
    """Encoder(mesh=) plain and packed over a 1-D and a hybrid mesh."""
    from dhr_tpu_torch.encode import (
        EncodeConfig, Encoder, iter_batches, packed_encode_batches)
    from dhr_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    model, cfg, _ = _train_setup(inp)
    out = {}
    for kind, mesh in (("data", make_mesh(axis="data")),
                       ("hybrid", make_hybrid_mesh(inner_axis="data",
                                                   num_hosts=2))):
        enc = Encoder(model, cfg, EncodeConfig(batch_size=inp["batch"],
                                               remove_dims=inp["remove"]),
                      device="cpu", mesh=mesh)
        plain = enc.encode_corpus(iter_batches(
            inp["ids"], inp["input_ids"], inp["mask"], inp["batch"]))
        batches, order = packed_encode_batches(
            inp["ids"], inp["toks"], inp["rows"], inp["row_len"], 4, 1, 2)
        packed = enc.encode_corpus_packed(batches)
        out[kind] = {"plain": (plain.values, plain.indices,
                               list(plain.docids)),
                     "packed": (packed.values, packed.indices,
                                list(packed.docids))}
    return out


@task
def mesh(inp):
    """The mesh helpers on real process groups."""
    from dhr_tpu_torch.parallel import (
        make_hybrid_mesh, make_mesh, replicate, row_axes, row_sharded,
        shard_batch, shard_coords)
    from dhr_tpu_torch.parallel.mesh import global_put, host_of_ranks

    rank = torch.distributed.get_rank()
    m = make_mesh(axis="data")
    h = make_hybrid_mesh(num_hosts=2, host_axis="pod")
    x = torch.arange(16.0).reshape(8, 2)
    d = global_put(x, m, row_sharded(m))
    rep = replicate({"w": torch.full((3,), float(rank))}, m)["w"]
    batch = {"a": np.arange(8)[:, None] * np.ones((1, 3)),
             "b": {"c": np.arange(8)}}
    return {
        "data_shape": (m.mesh_dim_names, m.size()),
        "hybrid": (h.mesh_dim_names, h.mesh.tolist()),
        "row_axes_hybrid": row_axes(h, "index"),
        "row_axes_1d": row_axes(m, "data"),
        "row_axes_missing": row_axes(h, "data"),
        "coords_hybrid": shard_coords(h, row_axes(h, "index")),
        "local_shard": d.to_local().numpy(),
        "full": d.full_tensor().numpy(),
        "replicated": rep.to_local().numpy(),
        "batch": shard_batch(batch, m),
        "batch_hybrid": shard_batch(batch, h),
        "hosts": host_of_ranks(),
    }


class HashTokenizer:
    """Whole words hashed into [remove, vocab) (crc32: the same ids in every
    process), as tests/test_torch_beir.py's FakeTokenizer."""

    def __init__(self, remove, vocab):
        self.remove, self.vocab = remove, vocab

    def encode(self, text, add_special_tokens=False, max_length=None,
               truncation=True):
        import zlib

        ids = [self.remove + zlib.crc32(w.encode()) % (self.vocab
                                                        - self.remove)
               for w in text.split()]
        return ids[: max_length or 16] or [self.remove]


@task
def beir(inp):
    """evaluate_beir with a data-parallel Encoder and a row-sharded
    index."""
    from dhr_tpu_torch.encode import EncodeConfig, Encoder
    from dhr_tpu_torch.eval.beir import evaluate_beir
    from dhr_tpu_torch.parallel import make_mesh
    from dhr_tpu_torch.retrieval import SearchConfig

    model, cfg, _ = _train_setup(inp)
    enc = Encoder(model, cfg, EncodeConfig(batch_size=inp["batch"],
                                           remove_dims=inp["remove"]),
                  device="cpu", mesh=make_mesh(axis="data"))
    return {name: evaluate_beir(
        enc, SearchConfig(**search), inp["dir"],
        HashTokenizer(inp["remove"], inp["enc"]["vocab_size"]),
        mesh=make_mesh(axis="index"), **inp["kw"])
        for name, search in inp["searches"].items()}


def main(argv):
    name, world, rank, init, inp_path, out_path = argv
    torch.set_num_threads(1)
    from dhr_tpu_torch.parallel import init_distributed

    _log(f"{name} on {world} ranks: joining")
    init_distributed("gloo", device="cpu", init_method=init, rank=int(rank),
                     world_size=int(world))
    _log("joined")
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    result = TASKS[name](inp)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    _log(f"{name} done")


if __name__ == "__main__":
    main(sys.argv[1:])
