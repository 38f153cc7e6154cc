"""Process groups, device meshes and sharding helpers on torch.distributed.

Port of ``dhr_tpu/parallel/mesh.py``.  JAX runs one program over a mesh of
devices; PyTorch runs one process per rank (``torchrun``), and a
``DeviceMesh`` over the ranks stands in for the JAX ``Mesh``, DTensor
placements (``Shard``, ``Replicate``) for ``PartitionSpec``.  The same axes
serve both subsystems:

- training: the batch is sharded over ``data`` (each rank forwards its
  rows; the loss sees the gathered global batch), parameters replicated
  or sharded (``parallel.tp``);
- retrieval: index rows are sharded over ``index``; each rank keeps only
  its contiguous rows and the per-shard top-k lists are merged after an
  all-gather (``retrieval.searcher``).

Backends are chosen by the caller, never by catching a failure: ``nccl``
when each rank has its own card (the default on the card), ``gloo`` on the
CPU (the tests) and ``gloo`` with CUDA tensors when several ranks share one
card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
INDEX_AXIS = "index"
HOST_AXIS = "host"
BACKENDS = ("nccl", "gloo")

# this rank's device, as init_distributed returned it: meshes live there
_rank_device: torch.device | None = None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed(backend: str | None = None,
                     device: str | torch.device | None = None,
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the default process group (once) and return this rank's device.

    ``rank``, ``world_size`` and ``init_method`` default to torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``).  ``device`` None is the card: under ``nccl`` rank
    ``LOCAL_RANK`` takes ``cuda:LOCAL_RANK``; under ``gloo`` the ranks of a
    host share its cards (``cuda:LOCAL_RANK % device_count``, so every rank
    of a one-card machine uses ``cuda:0``).  ``device="cpu"`` needs
    ``gloo``.  ``backend`` None is ``nccl`` on the card and ``gloo`` on the
    CPU.
    """
    global _rank_device
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if dev.type == "cpu" and backend == "nccl":
        raise ValueError("nccl needs CUDA tensors; use backend='gloo' on the "
                         "CPU")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' with "
                               "backend='gloo' to run the ranks on the CPU")
        local = _env_int("LOCAL_RANK", 0)
        if backend == "nccl":
            dev = torch.device("cuda", local)
        else:
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=_env_int("RANK", 0) if rank is None else rank,
            world_size=(_env_int("WORLD_SIZE", 1) if world_size is None
                        else world_size))
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    _rank_device = dev
    return dev


def is_rank0() -> bool:
    """True on rank 0, or without a process group (the one process): the
    rank that writes files and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def launched() -> bool:
    """True under a launcher that set a world (torchrun's ``WORLD_SIZE``)
    or once a process group exists."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def _mesh_device_type() -> str:
    # a mesh (and every DTensor of TP, FSDP and global_put) lives on this
    # rank's device: the card under either backend (gloo carries CUDA
    # tensors for ranks sharing one), the host for device="cpu".  A group
    # made without init_distributed: the card under NCCL, else the host.
    if _rank_device is not None:
        return _rank_device.type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def check_device(device, mesh, what: str) -> None:
    """Refuse to place ``what``, on ``device``, over a mesh of another
    device type: a DTensor put would move it there silently (a model on
    the card trained on the host).  Host data may go to a card's mesh."""
    kind = torch.device(device).type
    if kind not in ("cpu", mesh.device_type):
        raise ValueError(
            f"{what} is on {kind} but the mesh is on {mesh.device_type}: "
            f"build the mesh after init_distributed(device=...) names this "
            f"rank's device")


def _device_mesh(layout: np.ndarray, names: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_mesh_device_type(), torch.as_tensor(layout),
                      mesh_dim_names=names)


def make_mesh(axis: str = DATA_AXIS):
    """A 1-D mesh over every rank of the default group."""
    return _device_mesh(np.arange(dist.get_world_size()), (axis,))


def host_of_ranks() -> list[str]:
    """Each rank's host key: torchrun's node rank (``GROUP_RANK``) when
    set, else the hostname (one all-gather of objects)."""
    key = os.environ.get("GROUP_RANK")
    key = f"node{key}" if key is not None else socket.gethostname()
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    return keys


def hybrid_layout(hosts: list, num_hosts: int | None = None) -> np.ndarray:
    """The ``(num_hosts, per_host)`` rank layout of :func:`make_hybrid_mesh`
    for ranks on ``hosts`` (one key per rank), hosts in order of first
    appearance.  Raises when the ranks do not divide into ``num_hosts``
    rows, or when a row would span hosts."""
    n = len(hosts)
    distinct = list(dict.fromkeys(hosts))
    if num_hosts is None:
        num_hosts = len(distinct)
    if n % num_hosts:
        raise ValueError(f"{n} ranks do not divide into {num_hosts} hosts")
    order = sorted(range(n), key=lambda r: (distinct.index(hosts[r]), r))
    arr = np.asarray(order).reshape(num_hosts, n // num_hosts)
    # each mesh row must be ONE host's ranks (the heavy collectives stay
    # on its intra-host links); unequal per-host counts can pass the
    # divisibility check yet make rows span hosts.  num_hosts overrides
    # the grouping to rehearse a multi-host layout on one machine.
    if len(distinct) > 1:
        for row in arr:
            if len({hosts[r] for r in row}) > 1:
                counts = {h: hosts.count(h) for h in distinct}
                raise ValueError(
                    f"ranks do not group into {num_hosts} equal hosts: "
                    f"per-host counts {counts}; a mesh row would span "
                    f"processes of different hosts, putting the inner axis "
                    f"across machines")
    return arr


def make_hybrid_mesh(inner_axis: str = INDEX_AXIS, host_axis: str = HOST_AXIS,
                     num_hosts: int | None = None,
                     hosts: list | None = None):
    """A 2-D ``(host, inner)`` mesh with the host axis LEADING, each row
    one host's ranks (:func:`hybrid_layout`): row sharding over ``(host,
    inner)`` keeps the heavy collectives inside a host and crosses hosts
    only with the small merged results.  ``hosts`` defaults to
    :func:`host_of_ranks`; ``num_hosts`` overrides the grouping (e.g. to
    rehearse two hosts with four ranks on one machine)."""
    if hosts is None:
        hosts = host_of_ranks()
    return _device_mesh(hybrid_layout(hosts, num_hosts),
                        (host_axis, inner_axis))


def row_axes(mesh, axis: str = INDEX_AXIS) -> tuple[str, ...]:
    """The mesh axes row sharding spans: ``(outer, axis)`` on a 2-D hybrid
    mesh, else ``(axis,)``.  Outer-major order keeps shard ids contiguous
    per host.

    Any 2-D mesh holding ``axis`` counts as hybrid whatever its outer axis
    is called, but ``axis`` must be the LAST (inner) axis: a mesh ordered
    ``(index, host)`` would shard rows index-major and route the heavy
    stage-1 all-gather across hosts, so it is refused; for meshes of more
    than two dims only :data:`HOST_AXIS` is recognized as the outer one."""
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        return (axis,)
    if len(names) == 2:
        if names[-1] != axis:
            raise ValueError(
                f"hybrid mesh axes {names} put {axis!r} on the outer (host) "
                f"axis; build the mesh (outer, {axis!r}), e.g. with "
                f"make_hybrid_mesh, so heavy collectives stay inside a host")
        return names
    if HOST_AXIS in names:
        return (HOST_AXIS, axis)
    return (axis,)


def shard_coords(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """``(shard index, shard count)`` of this rank over ``axes``, the first
    axis major (host-major on a hybrid mesh)."""
    if mesh is None:
        return 0, 1
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in axes:
        size = mesh.size(names.index(a))
        index = index * size + coord[names.index(a)]
        count *= size
    return index, count


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates
    off ``axes``: one mesh dim's group, or the default group when ``axes``
    span a mesh over every rank."""
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(names) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise ValueError(f"rows sharded over {axes} of a mesh {names} of "
                     f"{mesh.size()} ranks: use one axis, or every axis of "
                     "a mesh over all ranks")


def replicated(mesh) -> list:
    """The placements of a tensor replicated over every mesh dim."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def row_sharded(mesh, axis: str | None = None) -> list:
    """Placements sharding dim 0 over ``axis`` (default the first mesh
    dim), replicated over the other dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    axis = axis or names[0]
    return [Shard(0) if n == axis else Replicate() for n in names]


def global_put(x, mesh, placements):
    """A DTensor of ``x`` with ``placements``: every rank passes the same
    global ``x`` and rank 0's copy is what lands (scattered or broadcast),
    the multi-process ``device_put`` of the reference."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(x)
    check_device(x.device, mesh, "the tensor")
    return distribute_tensor(x, mesh, placements)


def replicate(tree, mesh):
    """Every tensor of a (nested) dict / list replicated over ``mesh``,
    rank 0's values."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return global_put(tree, mesh, replicated(mesh))


def local_rows(x, index: int, count: int):
    """Rows ``[index * n / count, (index + 1) * n / count)`` of ``x``;
    ``n`` must divide evenly."""
    n = x.shape[0]
    if n % count:
        raise ValueError(f"{n} rows do not shard over {count} ranks; pad "
                         "them (pad_rows_to_multiple)")
    size = n // count
    return x[index * size:(index + 1) * size]


def shard_batch(batch, mesh, axis: str | tuple[str, ...] | None = None):
    """This rank's rows of every array of a (nested) host batch, in global
    row order: shard ``i`` of ``n`` over :func:`row_axes` (host-major on a
    hybrid mesh) takes the ``i``-th of ``n`` equal row blocks.  A tuple
    names the axes outright (e.g. ``("data",)`` of a ``(data, model)``
    mesh)."""
    if isinstance(axis, tuple):
        axes = axis
    else:
        axes = row_axes(mesh, axis or mesh.mesh_dim_names[-1])
    index, count = shard_coords(mesh, axes)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        return local_rows(x, index, count)

    return take(batch)


def pad_rows_to_multiple(array, multiple: int):
    """Pad the leading dim with zeros to a multiple; returns ``(padded,
    n_real)``.  The encode path fills every rank's rows this way (the
    reference pads its final pmap batch the same way)."""
    n = array.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return array, n
    widths = [(0, pad)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(np.asarray(array), widths), n
