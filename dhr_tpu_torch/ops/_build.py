"""Build the CUDA sources of ``dhr_tpu_torch/csrc`` on first use.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.  The
library's file name carries a hash of the sources and flags, so a build
reruns only when a source (or a shared ``.cuh`` header) changes.  Output
goes to ``build/kernels/`` beside the package.  A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("partial_gip", "rerank_gip", "gip_candidates",
           "lexical_pool", "moe_combine", "mla_attention",
           "kda_scan", "ssd_scan")  # csrc/<name>.cu
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# element-kind codes of csrc/common.cuh (enum dhr::Kind)
KIND = {
    torch.int8: 0,
    torch.int16: 1,
    torch.bfloat16: 2,
    torch.float16: 3,
    torch.float32: 4,
}

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "dhr_tpu_torch are built from source on first use"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together.  Returns ``{name: ptxas report}`` for the ones it
    built (empty for those already built)."""
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
