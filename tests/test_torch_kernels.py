"""CUDA kernels K1 / K2 against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a machine with a GPU and no JAX it runs with
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from dhr_tpu_torch.ops.partial_gip import (
    partial_gip,
    partial_gip_plain,
    select_important,
)
from dhr_tpu_torch.ops.rerank_gip import rerank_gip, rerank_gip_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planes(seed, D, lex, N, vdt, idt, n_folds=5):
    rng = np.random.default_rng(seed)
    vt = torch.from_numpy(rng.integers(-127, 128, (D, N)).astype(np.float32))
    it = torch.from_numpy(rng.integers(0, n_folds, (lex, N)))
    return vt.to(vdt), it.to(idt)


def _queries(seed, B, D, lex, n_folds=5):
    rng = np.random.default_rng(seed + 1)
    qv = np.where(rng.random((B, D)) > 0.5, rng.random((B, D)), 0.0)
    qi = np.concatenate([rng.integers(0, n_folds, (B, lex)),
                         np.ones((B, D - lex))], axis=1)
    return (torch.from_numpy(qv.astype(np.float32)),
            torch.from_numpy(qi.astype(np.int32)))


def _close(got, want, rel):
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(float(want[torch.isfinite(want)].abs().max()), 1.0)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert float((got[fin] - want[fin]).abs().max()) <= rel * scale


@pytest.mark.parametrize("N", [4096, 4099, 20011])
@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float16,
                                 torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_partial_gip_kernel_matches_plain(cuda, N, vdt, idt, out):
    D, lex, B = 40, 32, 6
    vt, it = _planes(0, D, lex, N, vdt, idt)
    qv, qi = _queries(0, B, D, lex)
    for n_imp in (12, D):
        imp = select_important(qv, qi, n_imp)
        imp_d = [x.to(cuda) for x in imp]
        before = partial_gip.launches
        got = partial_gip(*imp_d, vt.to(cuda), it.to(cuda), lex, out)
        torch.cuda.synchronize()
        assert partial_gip.launches == before + 1
        want = partial_gip_plain(*imp, vt, it, lex, out)
        _close(got, want, 1e-4 if out == torch.float32 else 8e-3)


@pytest.mark.parametrize("K", [37, 1001])
@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
def test_rerank_gip_kernel_matches_plain(cuda, K, vdt, idt):
    D, lex, N, B = 20, 16, 300, 5
    vt, it = _planes(1, D, lex, N, vdt, idt)
    values, indices = vt.T.contiguous(), it.T.contiguous()
    qv, qi = _queries(1, B, D, lex)
    rows = torch.from_numpy(
        np.random.default_rng(2).integers(0, N, (B, K)).astype(np.int64))
    rows[0, 0] = N       # out of range: never read, scores -inf
    rows[1, 1] = -1
    before = rerank_gip.launches
    got = rerank_gip(qv.to(cuda), qi.to(cuda), rows.to(cuda),
                     values.to(cuda), indices.to(cuda), lex)
    torch.cuda.synchronize()
    assert rerank_gip.launches == before + 1
    want = rerank_gip_plain(qv, qi, rows, values, indices, lex)
    _close(got, want, 1e-4)


def test_kernels_raise_on_bad_input(cuda):
    D, lex, N = 40, 32, 512
    vt, it = _planes(0, D, lex, N, torch.int8, torch.int8)
    qv, qi = _queries(0, 2, D, lex)
    imp = [x.to(cuda) for x in select_important(qv, qi, 4)]
    with pytest.raises(ValueError):
        partial_gip(*imp, vt.to(cuda).T, it.to(cuda), lex)   # not contiguous
    with pytest.raises(TypeError):
        partial_gip(*imp, vt.to(cuda).to(torch.int32), it.to(cuda), lex)
    with pytest.raises(ValueError):
        partial_gip(*imp, vt.to(cuda), it, lex)              # mixed devices
