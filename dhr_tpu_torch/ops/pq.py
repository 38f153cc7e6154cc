"""Product-quantization codebooks for pq-mode candidate generation.

Port of ``dhr_tpu/ops/pq.py`` (reference equivalence: faiss
``IndexPQ(dim, m, 8 bit, METRIC_INNER_PRODUCT)``, asymmetric-distance
inner products against the reconstructed vectors).  Plain PyTorch: none of
this is a Pallas kernel in the reference.  Every function runs on the
device of its inputs, and gives the same numbers from one run to the next
there (no atomics):

- :func:`train_pq` — Lloyd's k-means per subspace, all ``m`` subspaces
  batched; cluster sums by one-hot matmuls, as the reference's update does;
  empty clusters keep their previous centroid.  ``init_rows`` picks the
  starting centroids (the reference draws them with ``jax.random.choice``,
  which PyTorch cannot reproduce; by default the port draws them with numpy
  from ``seed``).
- :func:`encode_pq` / :func:`decode_pq` — codes ``(N, m)`` uint8; encoding
  widens one block of rows to f32 at a time.
- :func:`pq_luts` + :func:`pq_ip_scores` — ADC scores
  ``sum_j lut[b, j, codes[n, j]]``, each table entry rounded to bf16 and
  summed in f32 in subspace order, as the reference's bf16 one-hot matmul
  does; :func:`pq_ip_scores_gather` keeps the tables in f32 (the oracle).
  The tables are summed over the subvector's dims in order with one
  rounding per product and per add, so the CPU and the GPU build the same
  tables bit for bit.
- :func:`train_encode_pq` / :func:`train_encode_pq_np` — the offline build
  on a device (default the GPU): train on a row sample, then encode every
  row, moving one block of rows to the device at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from dhr_tpu_torch.device import resolve_device

N_CENTROIDS = 256  # 8-bit codes
_ROWS_PER_STEP = 65536  # rows per distance block (bounds the (m, n, 256) temp)
_ROWS_PER_UPDATE = 8192  # rows per one-hot block of the k-means update


def _split(values: torch.Tensor, m: int) -> torch.Tensor:
    """(N, D) -> (m, N, d_sub); D must divide by m."""
    N, D = values.shape
    if D % m:
        raise ValueError(f"dim {D} not divisible by m={m} subspaces")
    return values.reshape(N, m, D // m).transpose(0, 1)


def _nearest(x: torch.Tensor, centroids: torch.Tensor,
             c2: torch.Tensor) -> torch.Tensor:
    """Nearest centroid ``(m, n)`` of each subvector of ``x`` ``(m, n, d)``:
    argmin of the squared L2 distance by the reference's matmul identity."""
    d2 = ((x * x).sum(-1, keepdim=True)
          - 2.0 * torch.bmm(x, centroids.transpose(1, 2)) + c2)
    return d2.argmin(dim=-1)


def _assign(sub: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """:func:`_nearest` over ``sub`` ``(m, N, d)`` in row blocks."""
    c2 = (centroids * centroids).sum(-1)[:, None, :]
    return torch.cat([_nearest(sub[:, s:s + _ROWS_PER_STEP], centroids, c2)
                      for s in range(0, sub.shape[1], _ROWS_PER_STEP)], dim=1)


def _cluster_sums(sub: torch.Tensor, codes: torch.Tensor):
    """Per-centroid ``(sums (m, 256, d), counts (m, 256))`` of ``sub``
    ``(m, N, d)`` under ``codes`` ``(m, N)``: one-hot ``(m, 256, n) x (m,
    n, d)`` matmuls in row blocks, a fixed reduction order."""
    m, _, d = sub.shape
    sums = torch.zeros(m, N_CENTROIDS, d, device=sub.device)
    counts = torch.zeros(m, N_CENTROIDS, device=sub.device)
    for s in range(0, sub.shape[1], _ROWS_PER_UPDATE):
        oh = torch.nn.functional.one_hot(
            codes[:, s:s + _ROWS_PER_UPDATE], N_CENTROIDS).float()
        sums += torch.bmm(oh.transpose(1, 2), sub[:, s:s + _ROWS_PER_UPDATE])
        counts += oh.sum(dim=1)
    return sums, counts


def train_pq(values: torch.Tensor, m: int, iters: int = 15, seed: int = 0,
             init_rows=None) -> torch.Tensor:
    """K-means codebooks ``(m, 256, d_sub)`` f32 over the value plane.

    ``init_rows``: the 256 rows that seed the centroids (default: a numpy
    draw from ``seed``, with replacement when N < 256).
    """
    sub = _split(values.float(), m)  # (m, N, d)
    N = sub.shape[1]
    if init_rows is None:
        init_rows = np.random.default_rng(seed).choice(
            N, N_CENTROIDS, replace=N < N_CENTROIDS)
    init = torch.as_tensor(np.asarray(init_rows), device=sub.device).long()
    centroids = sub[:, init, :].clone()
    for _ in range(iters):
        sums, counts = _cluster_sums(sub, _assign(sub, centroids))
        means = sums / counts.clamp(min=1.0)[..., None]
        centroids = torch.where((counts > 0)[..., None], means, centroids)
    return centroids


def encode_pq(values: torch.Tensor, centroids: torch.Tensor,
              value_scales: torch.Tensor | None = None) -> torch.Tensor:
    """Codes ``(N, m)`` uint8: nearest centroid per subspace, on the
    centroids' device.  ``values`` (a tensor anywhere, or numpy) widens to
    f32 one block of rows at a time, times ``value_scales`` when given (an
    int8 plane)."""
    centroids = centroids.float()
    dev, m = centroids.device, centroids.shape[0]
    c2 = (centroids * centroids).sum(-1)[:, None, :]
    codes = torch.empty(values.shape[0], m, dtype=torch.uint8, device=dev)
    for s in range(0, values.shape[0], _ROWS_PER_STEP):
        block = torch.as_tensor(values[s:s + _ROWS_PER_STEP]).to(dev).float()
        if value_scales is not None:
            block = block * value_scales.to(dev)[None, :]
        codes[s:s + block.shape[0]] = _nearest(
            _split(block, m), centroids, c2).T.to(torch.uint8)
    return codes


def decode_pq(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Reconstruct ``(N, D)`` f32 from codes."""
    m, _, d_sub = centroids.shape
    j = torch.arange(m, device=codes.device)
    return centroids[j[None, :], codes.long()].reshape(codes.shape[0],
                                                       m * d_sub)


def pq_luts(qv: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Per-query inner-product tables ``(B, m, 256)`` f32, summed over the
    subvector's dims in order (bit-identical on every device)."""
    m, _, d_sub = centroids.shape
    q_sub = qv.float().reshape(qv.shape[0], m, 1, d_sub)
    c = centroids.float()[None]
    luts = q_sub[..., 0] * c[..., 0]
    for d in range(1, d_sub):
        luts = luts + q_sub[..., d] * c[..., d]
    return luts


def _adc(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(luts.shape[0], codes.shape[0], dtype=torch.float32,
                      device=luts.device)
    for j in range(luts.shape[1]):
        acc += luts[:, j, :].index_select(1, codes[:, j].long())
    return acc


def pq_ip_scores(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scores ``(B, N)`` with bf16 table entries summed in f32 — the
    numbers of the reference's bf16 one-hot matmul (exact products, f32
    accumulation in subspace order)."""
    return _adc(luts.to(torch.bfloat16).float(), codes)


def pq_ip_scores_gather(luts: torch.Tensor, codes: torch.Tensor
                        ) -> torch.Tensor:
    """ADC scores ``(B, N)`` from f32 tables (oracle)."""
    return _adc(luts.float(), codes)


def train_encode_pq(values, m: int, iters: int = 15, seed: int = 0,
                    train_sample: int = 65536,
                    value_scales: torch.Tensor | None = None,
                    device: str | torch.device | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(codes (N, m) u8, centroids (m, 256, d) f32)`` on ``device``
    (default the GPU) for ``values`` (N, D): numpy or a tensor anywhere,
    float, or int8 with ``value_scales``.  Trains on a ``train_sample``-row
    numpy draw from ``seed`` (the reference's draw) when N is larger."""
    dev = resolve_device(device)
    n = values.shape[0]
    sample = values
    if n > train_sample:
        rows = np.random.default_rng(seed).choice(
            n, train_sample, replace=False)
        sample = values[rows if isinstance(values, np.ndarray)
                        else torch.from_numpy(rows).to(values.device)]
    sample = torch.as_tensor(sample).to(dev).float()
    if value_scales is not None:
        sample = sample * value_scales.to(dev)[None, :]
    centroids = train_pq(sample, m, iters, seed)
    return encode_pq(values, centroids, value_scales), centroids


def train_encode_pq_np(values: np.ndarray, m: int, iters: int = 15,
                       seed: int = 0, train_sample: int = 65536,
                       device: str | torch.device | None = None,
                       ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`train_encode_pq` of a float numpy plane on ``device``
    (default the GPU), returned as numpy."""
    codes, centroids = train_encode_pq(
        np.asarray(values, np.float32), m, iters, seed, train_sample,
        device=device)
    return codes.cpu().numpy(), centroids.cpu().numpy()
