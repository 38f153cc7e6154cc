"""dhr_tpu_torch — the PyTorch / CUDA port of dhr_tpu for NVIDIA Hopper.

The search subsystem of ``dhr_tpu`` on one GPU: gip, ip and pq search over
a DHR index, fused candidates, row chunking, escalation, pool calibration,
and evaluation.

Subpackages mirror ``dhr_tpu``:

- ``ops``: quantization, the GIP oracle ops, top-k, PQ, and the three
  hand-written CUDA kernels of the search paths (``partial_gip``: the
  theta pass; ``gip_candidates``: the theta pass fused with a per-group
  argmax; ``rerank_gip``: the exact candidate rerank), each beside its
  plain PyTorch version.
- ``retrieval``: packed index I/O, device planes, the searcher, pool
  calibration, the synthetic corpus generator and TREC I/O.
- ``eval``: ranking metrics (NumPy).
- ``cli``: the ``index``, ``search``, ``merge-runs`` and ``eval`` verbs.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
"""

__version__ = "0.1.0"
