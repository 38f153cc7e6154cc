"""KDA's chunked recurrence (``ops/kda_scan.py``) on the CPU, and K7 on the
card.

The plain version, ``decoder.kda_scan``, is what the decoder's
``KDA.forward`` runs on the CPU and wherever autograd records; the wrapper
``fused_kda_scan`` refuses what K7 does not take on any device and sends a
CPU tensor to the plain version, bit for bit.

Card tests (skipped without a CUDA device; this file imports no JAX, so
``python -m pytest --noconftest tests/test_torch_kda_scan.py`` runs them
there) use the Kimi cell's largest bucket, 2 x 2,048 positions, 32 heads of
128, the second row zero past 1,500 positions, with the published decay
inits (``A_log = log U(1, 16)``, ``dt_bias = softplus^-1(U(1e-3, 0.1))``),
so a chunk's log-decay runs past -100.  Tolerances, each with its reason:

- K7 against the plain scan from the same f32 inputs within 1e-5 of the
  output's largest value: both are f32 throughout, the sums in other
  orders (K7 nests its decay splits where the plain scan takes sub-chunks
  of 8, and solves and multiplies in its own order);
- K7 no farther from an f64 evaluation of the token-by-token recurrence
  (``tests/kimi_linear_reference.py``) than 1.5 times the plain scan is:
  both round in f32, neither should drift more than the other;
- from bf16 inputs laid out as the short convolution gives them
  (channel-major, read in place), K7's bf16 output within one bf16 ulp of
  the plain scan's, element by element (each rounds an f32 value that
  agrees to ~1e-6 of the scale; an element near zero may take 1e-5 of the
  scale instead).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kimi_linear_reference as ref
from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.models.decoder import DecoderConfig
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.kda_scan import HEAD_DIMS, fused_kda_scan
from dhr_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scan_inputs(B, L, h, d, seed=0, cut=None, device="cpu",
                dtype=torch.float32, channel_major=False):
    """``(q, k, v, g, beta)``: q, k, v ``N(0, 1)`` in ``dtype``; g from the
    published decay inits, ``-exp(A_log) softplus(f + dt_bias)`` with ``f``
    ``N(0, 1)``; beta ``U(0, 1)``.  Row 1 is zero past ``cut``.  With
    ``channel_major``, q, k and v are (B, L, h, d) views of (B, h d, L)
    storage, as ``ShortConv`` returns them."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, L, h, d, generator=gen) for _ in range(3))
    a_log = torch.empty(h, 1).uniform_(1, 16, generator=gen).log_()
    dt = torch.empty(h, d).uniform_(1e-3, 1e-1, generator=gen)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    f = torch.randn(B, L, h, d, generator=gen)
    g = -a_log.exp() * F.softplus(f + dt_bias)
    beta = torch.rand(B, L, h, generator=gen)
    out = [q, k, v, g, beta]
    if cut is not None:
        for t in out:
            t[1, cut:] = 0.0
    q, k, v, g, beta = (t.to(device) for t in out)
    if channel_major:
        q, k, v = (t.reshape(B, L, h * d).transpose(1, 2).contiguous()
                   .to(dtype).transpose(1, 2).reshape(B, L, h, d)
                   for t in (q, k, v))
    else:
        q, k, v = (t.to(dtype) for t in (q, k, v))
    return q, k, v, g, beta


# -- on the CPU --------------------------------------------------------------


def test_wrapper_on_the_cpu_is_the_plain_scan():
    """A CPU tensor goes to the plain scan, bit for bit, and launches
    nothing."""
    args = scan_inputs(2, 70, 3, 8, seed=1, cut=40)
    profiling.reset()
    got = fused_kda_scan(*args)
    assert torch.equal(got, dec.kda_scan(*args))
    assert kernel_launches()["kda_scan"] == 0


def _bad(kind):
    q, k, v, g, beta = scan_inputs(1, 9, 2, 8, seed=2)
    if kind == "head_dim":
        q, k, v, g = (t.repeat(1, 1, 1, 2) for t in (q, k, v, g))
    elif kind == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif kind == "mixed":
        v = v.bfloat16()
    elif kind == "g_dtype":
        g = g.bfloat16()
    elif kind == "shape":
        k = k[:, :8]
    elif kind == "beta_shape":
        beta = beta[..., None]
    elif kind == "rank":
        q, k, v, g = (t.flatten(2) for t in (q, k, v, g))
    elif kind == "grad":
        q.requires_grad_(True)
    return q, k, v, g, beta


@pytest.mark.parametrize("kind,error,match", [
    ("head_dim", ValueError, "head dim 16"),
    ("dtype", TypeError, "dtypes"),
    ("mixed", TypeError, "dtypes"),
    ("g_dtype", TypeError, "g dtype"),
    ("shape", ValueError, "k .* must match q"),
    ("beta_shape", ValueError, "beta"),
    ("rank", ValueError, r"\(B, L, h, d\)"),
    ("grad", RuntimeError, "no backward"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind, error, match):
    with pytest.raises(error, match=match):
        fused_kda_scan(*_bad(kind))


def test_head_dims_are_the_kimi_configs():
    assert DecoderConfig.kimi_linear_48b_a3b().kda_head_dim in HEAD_DIMS
    assert DecoderConfig.tiny_kimi_linear().kda_head_dim in HEAD_DIMS


@pytest.mark.parametrize("grad", [False, True])
def test_a_cpu_layer_takes_the_plain_scan(grad, monkeypatch):
    """``KDA.forward`` on the CPU calls the plain scan, with autograd on
    or off, and never the wrapper; nothing is launched.  (The spies stand
    in for the scan's output: the plain scan's ``out=`` products take no
    autograd.)"""
    calls = []
    monkeypatch.setattr(dec, "kda_scan", lambda *a: calls.append("plain")
                        or torch.zeros_like(a[2]))
    monkeypatch.setattr(dec, "fused_kda_scan", lambda *a: calls.append("k7")
                        or torch.zeros_like(a[2]))
    layer = dec.KDA(DecoderConfig.tiny_kimi_linear(dtype=torch.float32))
    dec.init_weights(layer, 0.1)
    x = torch.randn(2, 70, 32)
    profiling.reset()
    with torch.set_grad_enabled(grad):
        out = layer(x)
    assert calls == ["plain"] and out.requires_grad == grad
    assert kernel_launches()["kda_scan"] == 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gap(got, want, real):
    """Largest |got - want| over the real positions / want's largest."""
    return float((got.double() - want.double())[real].abs().max()
                 / want.double()[real].abs().max())


@pytest.fixture(scope="module")
def bucket():
    """The cell's largest bucket on the card, f32: inputs, the real
    positions, the plain scan's output and K7's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = scan_inputs(2, 2048, 32, 128, seed=24, cut=1500, device="cuda")
    real = torch.ones(2, 2048, dtype=torch.bool, device="cuda")
    real[1, 1500:] = False
    with torch.no_grad():
        plain = dec.kda_scan(*args)
        got = fused_kda_scan(*args)
    torch.cuda.synchronize()
    return args, real, plain, got


def test_k7_matches_the_plain_scan_in_f32(bucket):
    args, real, plain, got = bucket
    g = args[3]
    chunk_decay = g[0, :64].sum(0).min()
    assert float(chunk_decay) < -100, float(chunk_decay)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _gap(got, plain, real) <= 1e-5


def test_k7_is_as_close_to_f64_as_the_plain_scan(bucket):
    args, real, plain, got = bucket
    q, k, v, g, beta = (t.double() for t in args)
    d = q.shape[-1]
    with torch.no_grad():
        want = ref.kda_recurrence(ref.l2norm(q) * d ** -0.5, ref.l2norm(k),
                                  v, g, beta)
    k7_gap, plain_gap = _gap(got, want, real), _gap(plain, want, real)
    assert k7_gap <= 1.5 * plain_gap, (k7_gap, plain_gap)


def test_k7_reads_the_convolutions_bf16_layout_in_place(cuda):
    """bf16 q, k, v as ``ShortConv`` leaves them (token stride 1): K7's
    bf16 output within one bf16 ulp of the plain scan's from the same
    tensors, with 1e-5 of the scale as the floor near zero."""
    args = scan_inputs(2, 2048, 32, 128, seed=7, cut=1500, device=cuda,
                       dtype=torch.bfloat16, channel_major=True)
    assert args[0].stride()[1] == 1
    with torch.no_grad():
        want = dec.kda_scan(*args).float()
        got = fused_kda_scan(*args)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    got = got.float()
    assert torch.isfinite(got).all()
    top = float(want.abs().max())
    mag = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    bad = (got - want).abs() > torch.maximum(ulp, torch.full_like(ulp,
                                                                  1e-5 * top))
    assert not bad.any(), int(bad.sum())


@pytest.mark.parametrize("L,d", [(1, 128), (63, 128), (64, 128), (65, 128),
                                 (2047, 128), (200, 8), (1, 8), (65, 8)])
def test_k7_matches_the_plain_scan_at_edge_lengths(cuda, L, d):
    h = 4 if d == 128 else 3
    args = scan_inputs(2, L, h, d, seed=L + d, cut=L // 2 + 1, device=cuda)
    real = torch.ones(2, L, dtype=torch.bool, device=cuda)
    real[1, L // 2 + 1:] = False
    with torch.no_grad():
        want = dec.kda_scan(*args)
        got = fused_kda_scan(*args)
    assert got.shape == (2, L, h, d) and torch.isfinite(got).all()
    assert _gap(got, want, real) <= 1e-5


def test_the_launch_counter_counts_kda_layers_without_autograd(
        cuda, monkeypatch):
    """A ``tiny_kimi_linear`` forward on the card (KDA layers 1, 2, 4):
    three K7 launches under ``no_grad``, none with autograd on (where the
    layers take the plain scan, stood in for by zeros: its ``out=``
    products take no autograd)."""
    cfg = DecoderConfig.tiny_kimi_linear(dtype=torch.bfloat16,
                                         param_dtype=torch.bfloat16)
    torch.manual_seed(0)
    with torch.device(cuda):
        model = dec.DecoderModel(cfg)
    dec.init_weights(model, 0.02)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 1024, (2, 90))).to(cuda)
    mask = torch.ones_like(ids)
    mask[1, 50:] = 0
    before = kernel_launches()["kda_scan"]
    with torch.no_grad():
        out = model(ids, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert kernel_launches()["kda_scan"] == before + 3
    plain = []
    monkeypatch.setattr(dec, "kda_scan", lambda *a: plain.append(1)
                        or torch.zeros_like(a[2]))
    model.requires_grad_(True)
    model(ids, mask)
    assert kernel_launches()["kda_scan"] == before + 3 and len(plain) == 3
