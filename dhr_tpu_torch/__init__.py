"""dhr_tpu_torch — the PyTorch / CUDA port of dhr_tpu for NVIDIA Hopper.

Everything ``dhr_tpu`` does: gip, ip and pq search over a DHR index (fused
candidates, row chunking, escalation, pool calibration), encoding,
training, offline densification, serving and evaluation, on one GPU or,
through ``parallel``, over ranks of ``torch.distributed`` (row-sharded
search and serving, data-parallel encoding, DP / FSDP / TP training).

Subpackages mirror ``dhr_tpu``:

- ``ops``: quantization, the GIP oracle ops, top-k, PQ, and the three
  hand-written CUDA kernels of the search paths (``partial_gip``: the
  theta pass; ``gip_candidates``: the theta pass fused with a per-group
  argmax; ``rerank_gip``: the exact candidate rerank), each beside its
  plain PyTorch version.
- ``retrieval``: packed index I/O, device planes, the searcher, pool
  calibration, the synthetic corpus generator, ColBERT MaxSim retrieval
  and TREC I/O.
- ``eval``: ranking metrics (NumPy), rerank evaluation of candidate lists
  and the BEIR harness.
- ``utils``: format converters, phase timing and profiler traces.
- ``parallel``: process groups and device meshes (``torchrun``, NCCL or
  gloo), sharding helpers, the collectives of the sharded paths, and the
  TP / FSDP parameter rules.
- ``cli``: the verbs of ``python -m dhr_tpu_torch``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
"""

__version__ = "0.1.0"
