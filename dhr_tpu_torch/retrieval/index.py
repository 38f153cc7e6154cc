"""The retrieval index: packed value/index planes and their device copies.

Port of ``dhr_tpu/retrieval/index.py``.  On disk (byte-compatible with
``dhr_tpu`` in both directions): an ``.npz`` holding

- ``values``  (N, lex_dim + cls_dim) f16/bf16/f32, or int8 with
  ``value_scales`` (D,) f32;
- ``indices`` (N, lex_dim) uint8/int8/int16 fold indices (absent for dense);
- ``lex_dim``, and optionally ``pq_codes`` / ``pq_centroids``;

plus a sidecar ``.docids.json``.  A compatibility reader ingests the
reference's pickle triple ``[values, indices, ids]``.

On the device, :class:`DeviceIndex` keeps the row-major planes (the rerank's
row gathers) and/or their dim-major twins (the theta pass reads one dim row
per important dim), each contiguous.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import torch

from dhr_tpu_torch.device import resolve_device
from dhr_tpu_torch.ops.quantize import quantize_per_dim_np


@dataclasses.dataclass
class PackedIndex:
    """Host-side packed index (numpy); device residency via DeviceIndex."""

    values: np.ndarray                 # (N, lex+cls)
    indices: np.ndarray | None         # (N, lex) u8/i8/i16 or None
    docids: np.ndarray                 # (N,) str
    lex_dim: int
    value_scales: np.ndarray | None = None   # (D,) f32 when values are int8
    pq_codes: np.ndarray | None = None       # (N, m) u8 PQ codes
    pq_centroids: np.ndarray | None = None   # (m, 256, D/m) f32 codebooks

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    @property
    def cls_dim(self) -> int:
        return self.dim - self.lex_dim if self.indices is not None else 0

    @staticmethod
    def merge(shards: list["PackedIndex"]) -> "PackedIndex":
        """Concatenate shard rows."""
        has_idx = shards[0].indices is not None
        return PackedIndex(
            values=np.concatenate([s.values for s in shards], axis=0),
            indices=(
                np.concatenate([s.indices for s in shards], axis=0)
                if has_idx else None
            ),
            docids=np.concatenate([s.docids for s in shards]),
            lex_dim=shards[0].lex_dim,
        )

    def quantize(self) -> "PackedIndex":
        """Per-dim int8 quantization of the value plane."""
        q, scales = quantize_per_dim_np(self.values)
        return dataclasses.replace(self, values=q, value_scales=scales)

    def quantize_pq(self, m: int = 64, iters: int = 15, seed: int = 0,
                    device: str | torch.device | None = None
                    ) -> "PackedIndex":
        """Attach PQ codebooks: codes (N, m) u8 + (m, 256, D/m) centroids,
        trained on the float value plane (the reference's faiss PQ64
        storage).  Training and encoding run on ``device`` (default the
        GPU); the codes come back to the host."""
        if self.value_scales is not None:
            raise ValueError("PQ-quantize the float index, not the int8 one")
        from dhr_tpu_torch.ops.pq import train_encode_pq_np

        codes, centroids = train_encode_pq_np(
            self.values.astype(np.float32), m, iters=iters, seed=seed,
            device=device)
        return dataclasses.replace(self, pq_codes=codes,
                                   pq_centroids=centroids)

    def slice_rows(self, start: int, stop: int) -> "PackedIndex":
        return dataclasses.replace(
            self,
            values=self.values[start:stop],
            indices=None if self.indices is None else self.indices[start:stop],
            docids=self.docids[start:stop],
            pq_codes=None if self.pq_codes is None
            else self.pq_codes[start:stop],
        )

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        arrays = {"values": self.values, "lex_dim": np.asarray(self.lex_dim)}
        if self.indices is not None:
            arrays["indices"] = self.indices
        if self.value_scales is not None:
            arrays["value_scales"] = self.value_scales
        if self.pq_codes is not None:
            arrays["pq_codes"] = self.pq_codes
            arrays["pq_centroids"] = self.pq_centroids
        np.savez(path, **arrays)
        with open(self._docids_path(path), "w") as f:
            json.dump([str(d) for d in self.docids], f)

    @staticmethod
    def load(path: str) -> "PackedIndex":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            values = z["values"]
            indices = z["indices"] if "indices" in z.files else None
            lex_dim = int(z["lex_dim"])
            scales = z["value_scales"] if "value_scales" in z.files else None
            pq_codes = z["pq_codes"] if "pq_codes" in z.files else None
            pq_centroids = (
                z["pq_centroids"] if "pq_centroids" in z.files else None
            )
        with open(PackedIndex._docids_path(path)) as f:
            docids = np.asarray(json.load(f), dtype=object)
        return PackedIndex(values, indices, docids, lex_dim, scales,
                           pq_codes, pq_centroids)

    @staticmethod
    def _docids_path(path: str) -> str:
        base = path[:-4] if path.endswith(".npz") else path
        return base + ".docids.json"

    @staticmethod
    def load_reference_pickle(path: str,
                              lex_dim: int | None = None) -> "PackedIndex":
        """Ingest the reference's ``[values, indices, ids]`` pickle shard
        (a file this pipeline wrote: unpickling runs code)."""
        with open(path, "rb") as f:
            values, indices, ids = pickle.load(f)
        if lex_dim is None:
            lex_dim = indices.shape[1] if indices is not None \
                else values.shape[1]
        return PackedIndex(
            values=np.asarray(values),
            indices=None if indices is None else np.asarray(indices),
            docids=np.asarray([str(i) for i in ids], dtype=object),
            lex_dim=lex_dim,
        )

    @staticmethod
    def merge_glob(pattern: str, lex_dim: int | None = None) -> "PackedIndex":
        """Merge shard files (.npz or reference pickles) matching a glob."""
        paths = sorted(glob.glob(pattern))
        if not paths:
            raise FileNotFoundError(pattern)
        shards = []
        for p in paths:
            if p.endswith(".npz"):
                shards.append(PackedIndex.load(p))
            else:
                shards.append(PackedIndex.load_reference_pickle(p, lex_dim))
        return PackedIndex.merge(shards)


def _check_layout(layout: str) -> None:
    if layout not in ("both", "row", "dim"):
        raise ValueError(
            f"layout must be 'both', 'row', or 'dim'; got {layout!r}"
        )


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``; a read-only numpy array is copied first."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return torch.as_tensor(x, device=device)


def _widen_indices(indices: torch.Tensor) -> torch.Tensor:
    """uint8 -> int8 when every fold is < 128, else int16: reinterpreting
    uint8 >= 128 as int8 would change the value."""
    if indices.dtype == torch.uint8:
        fits = indices.numel() == 0 or int(indices.max()) < 128
        return indices.to(torch.int8 if fits else torch.int16)
    return indices


@dataclasses.dataclass
class DeviceIndex:
    """Device-resident index planes.

    ``layout``: "both" (gip + rerank), "row" (ip/pq candidates + rerank)
    or "dim" (gip without rerank) decides which orientations exist.
    """

    values: torch.Tensor | None        # (N, D) int8/bf16/f16/f32
    values_T: torch.Tensor | None      # (D, N)
    indices: torch.Tensor | None       # (N, lex) int8/int16
    indices_T: torch.Tensor | None     # (lex, N)
    docids: np.ndarray                 # host-side
    lex_dim: int
    num_rows: int
    value_scales: torch.Tensor | None = None  # (D,) f32
    pq_codes: torch.Tensor | None = None      # (N, m) uint8
    pq_centroids: torch.Tensor | None = None  # (m, 256, D/m) f32

    @property
    def device(self) -> torch.device:
        plane = self.values if self.values is not None else self.values_T
        return plane.device

    @property
    def dim(self) -> int:
        if self.values is not None:
            return self.values.shape[1]
        return self.values_T.shape[0]

    @staticmethod
    def from_arrays(values, indices, docids, lex_dim: int, value_scales=None,
                    layout: str = "both",
                    device: str | torch.device | None = None,
                    ) -> "DeviceIndex":
        """Build from numpy arrays or tensors (e.g. a synthetic corpus made
        on the device); transposes happen on the device.  Planes keep their
        dtype; uint8 folds widen as in :func:`_widen_indices`."""
        _check_layout(layout)
        dev = resolve_device(device)
        values = _as_tensor(values, dev)
        dv = values.contiguous() if layout != "dim" else None
        dvt = values.T.contiguous() if layout != "row" else None
        di = dit = None
        if indices is not None:
            indices = _widen_indices(_as_tensor(indices, dev))
            if layout != "dim":
                di = indices.contiguous()
            if layout != "row":
                dit = indices.T.contiguous()
        return DeviceIndex(
            values=dv, values_T=dvt, indices=di, indices_T=dit,
            docids=np.asarray(docids), lex_dim=int(lex_dim),
            num_rows=values.shape[0],
            value_scales=None if value_scales is None
            else _as_tensor(value_scales, dev).float(),
        )

    @staticmethod
    def from_packed(packed: PackedIndex, value_dtype=None,
                    layout: str = "both",
                    device: str | torch.device | None = None,
                    ) -> "DeviceIndex":
        """Planes of ``packed`` on ``device`` (default: the GPU).

        ``value_dtype``: None keeps int8 planes int8 and stores float planes
        as bf16; a torch float dtype converts (round to nearest even).
        """
        _check_layout(layout)
        dev = resolve_device(device)
        values = torch.from_numpy(np.ascontiguousarray(packed.values))
        if value_dtype is None:
            value_dtype = torch.int8 if values.dtype == torch.int8 \
                else torch.bfloat16
        if value_dtype != torch.int8:
            values = values.to(value_dtype)
        values = values.to(dev)
        dv = values if layout != "dim" else None
        dvt = values.T.contiguous() if layout != "row" else None
        di = dit = None
        if packed.indices is not None:
            indices = _widen_indices(torch.from_numpy(
                np.ascontiguousarray(packed.indices))).to(dev)
            if layout != "dim":
                di = indices
            if layout != "row":
                dit = indices.T.contiguous()
        scales = None
        if packed.value_scales is not None:
            scales = torch.from_numpy(
                packed.value_scales.astype(np.float32)).to(dev)
        codes = centroids = None
        if packed.pq_codes is not None:
            codes = _as_tensor(packed.pq_codes, dev)
            centroids = _as_tensor(
                packed.pq_centroids.astype(np.float32), dev)
        return DeviceIndex(
            values=dv, values_T=dvt, indices=di, indices_T=dit,
            docids=packed.docids, lex_dim=packed.lex_dim,
            num_rows=packed.num_rows, value_scales=scales,
            pq_codes=codes, pq_centroids=centroids,
        )
