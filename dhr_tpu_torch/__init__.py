"""dhr_tpu_torch — the PyTorch / CUDA port of dhr_tpu for NVIDIA Hopper.

The first slice of the port: GIP search over a DHR index on one GPU.

Subpackages mirror ``dhr_tpu``:

- ``ops``: quantization, the GIP oracle ops, top-k, and the two hand-written
  CUDA kernels of the search path (``partial_gip``: the theta pass;
  ``rerank_gip``: the exact candidate rerank), each beside its plain
  PyTorch version.
- ``retrieval``: packed index I/O, device planes, the searcher, the
  synthetic corpus generator and TREC I/O.
- ``cli``: the ``index`` and ``search`` verbs.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
"""

__version__ = "0.1.0"
