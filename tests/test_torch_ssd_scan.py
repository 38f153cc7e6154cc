"""Mamba-2's chunked SSD scan (``ops/ssd_scan.py``) on the CPU, and K8 on the
card.

The plain version, ``decoder.ssd_scan``, is what the decoder's
``Mamba2.forward`` runs on the CPU and wherever autograd records; the
wrapper ``fused_ssd_scan`` refuses what K8 does not take on any device and
sends a CPU tensor to the plain version, bit for bit.

Card tests (skipped without a CUDA device; this file imports no JAX, so
``python -m pytest --noconftest tests/test_torch_ssd_scan.py`` runs them
there) use NVIDIA-Nemotron-3-Nano-30B-A3B's widths (64 heads of 64, 8
groups of state 128, chunks of 128) and the published ``dt`` init
(``dt_bias = softplus^-1(dt0)``, ``dt0`` log-uniform in [1e-3, 0.1]) with
``A = -(1..64)``, the decays of ``A_log = log(1..h)``.  Tolerances, each with
its reason:

- K8 against the plain scan from the same f32 inputs within 1e-6 of the
  output's largest value: both are f32 throughout, the sums in other
  orders (K8 factors each decay over blocks of 8 positions and sums the
  state's product over its own tiles);
- K8 no farther from an f64 evaluation of the token-by-token recurrence
  (``tests/nemotron_h_reference.py``) than 1.5 times the plain scan is,
  with decays past -800 a chunk: both round in f32, neither should drift
  more than the other;
- from bf16 inputs laid out as the convolution gives them (``ShortConv``'s
  output, channel-major, read in place), K8's bf16 output within one bf16
  ulp of the plain scan's, element by element (each rounds an f32 value
  that agrees to ~1e-7 of the scale; an element near zero may take 1e-5 of
  the scale instead).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nemotron_h_reference as ref
from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.models.decoder import DecoderConfig
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.ssd_scan import SHAPES, fused_ssd_scan
from dhr_tpu_torch.utils import profiling

NANO = (64, 64, 8, 128)   # heads, head dim, groups, state


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scan_inputs(Bt, L, h=4, P=8, g=2, N=16, seed=0, cut=None, device="cpu",
                dtype=torch.float32, dt_scale=1.0):
    """``(x, dt, A, B, C, D)``: x, B, C ``N(0, 1)`` in ``dtype``; dt from
    the published init times ``dt_scale``, ``A = -(1..h)``, ``D`` about 1.
    Row 1 is zero past ``cut``."""
    gen = torch.Generator().manual_seed(seed)
    dt0 = torch.empty(h).uniform_(math.log(1e-3), math.log(0.1),
                                  generator=gen).exp_().clamp_(min=1e-4)
    dt = F.softplus(torch.randn(Bt, L, h, generator=gen) + dt0
                    + torch.log(-torch.expm1(-dt0))) * dt_scale
    x = torch.randn(Bt, L, h, P, generator=gen)
    B, C = (torch.randn(Bt, L, g, N, generator=gen) for _ in range(2))
    A = -torch.arange(1, h + 1, dtype=torch.float32)
    D = 1 + 0.1 * torch.randn(h, generator=gen)
    out = [x, dt, A, B, C, D]
    if cut is not None:
        for t in (x, dt, B, C):
            t[1, cut:] = 0.0
    x, B, C = (t.to(dtype) for t in (x, B, C))
    return tuple(t.to(device) for t in (x, dt, A, B, C, D))


# -- on the CPU --------------------------------------------------------------


def test_wrapper_on_the_cpu_is_the_plain_scan():
    """A CPU tensor goes to the plain scan, bit for bit, and launches
    nothing."""
    args = scan_inputs(2, 40, seed=1, cut=25)
    profiling.reset()
    got = fused_ssd_scan(*args, 16)
    assert torch.equal(got, dec.ssd_scan(*args, chunk=16))
    assert kernel_launches()["ssd_scan"] == 0


def _bad(kind):
    x, dt, A, B, C, D = scan_inputs(1, 9, seed=2)
    chunk = 16
    if kind == "head_dim":
        x = x.repeat(1, 1, 1, 2)
    elif kind == "state":
        B, C = B.repeat(1, 1, 1, 2), C.repeat(1, 1, 1, 2)
    elif kind == "chunk":
        chunk = 32
    elif kind == "per_group":
        B, C = B[:, :, :1], C[:, :, :1]
    elif kind == "groups":
        B, C = B.repeat(1, 1, 3, 1)[:, :, :3], C.repeat(1, 1, 3, 1)[:, :, :3]
    elif kind == "dtype":
        x, B, C = x.half(), B.half(), C.half()
    elif kind == "mixed":
        B = B.bfloat16()
    elif kind == "dt_dtype":
        dt = dt.bfloat16()
    elif kind == "D_dtype":
        D = D.double()
    elif kind == "C_shape":
        C = C[:, :8]
    elif kind == "dt_shape":
        dt = dt[..., None]
    elif kind == "A_shape":
        A = A[:3]
    elif kind == "rank":
        x = x.flatten(2)
    elif kind == "device":
        dt = dt.to("meta")
    elif kind == "grad":
        x.requires_grad_(True)
    return x, dt, A, B, C, D, chunk


@pytest.mark.parametrize("kind,error,match", [
    ("head_dim", ValueError, r"\(16, 16, 16, 2\): the kernel takes"),
    ("state", ValueError, r"\(8, 32, 16, 2\)"),
    ("chunk", ValueError, r"\(8, 16, 32, 2\)"),
    ("per_group", ValueError, r"\(8, 16, 16, 4\)"),
    ("groups", ValueError, "do not split into 3 groups"),
    ("dtype", TypeError, "dtypes"),
    ("mixed", TypeError, "dtypes"),
    ("dt_dtype", TypeError, "dt dtype"),
    ("D_dtype", TypeError, "D dtype"),
    ("C_shape", ValueError, "C .* must match B"),
    ("dt_shape", ValueError, "dt"),
    ("A_shape", ValueError, r"A \(3,\) must be \(4,\)"),
    ("rank", ValueError, r"\(Bt, L, h, P\)"),
    ("device", ValueError, "one device"),
    ("grad", RuntimeError, "no backward"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind, error, match):
    with pytest.raises(error, match=match):
        fused_ssd_scan(*_bad(kind))


def test_shapes_are_the_nemotron_configs():
    for cfg in (DecoderConfig.nemotron_3_nano_30b_a3b(),
                DecoderConfig.tiny_nemotron_h()):
        assert (cfg.mamba_head_dim, cfg.ssm_state_size, cfg.chunk_size,
                cfg.mamba_num_heads // cfg.n_groups) in SHAPES


@pytest.mark.parametrize("grad", [False, True])
def test_a_cpu_layer_takes_the_plain_scan(grad, monkeypatch):
    """``Mamba2.forward`` on the CPU calls the plain scan, with autograd on
    or off, and never the wrapper; nothing is launched."""
    calls = []
    plain = dec.ssd_scan
    monkeypatch.setattr(dec, "ssd_scan", lambda *a: calls.append("plain")
                        or plain(*a))
    monkeypatch.setattr(dec, "fused_ssd_scan", lambda *a: calls.append("k8")
                        or plain(*a))
    layer = dec.Mamba2(DecoderConfig.tiny_nemotron_h(dtype=torch.float32))
    dec.init_weights(layer, 0.1)
    x = torch.randn(2, 40, 32)
    profiling.reset()
    with torch.set_grad_enabled(grad):
        out = layer(x)
    assert calls == ["plain"] and out.requires_grad == grad
    assert kernel_launches()["ssd_scan"] == 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gap(got, want, real=None):
    """Largest |got - want| (over the real positions) / want's largest."""
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    if real is not None:
        d, w = d[real], w[real]
    return float(d.max() / w.max())


@pytest.mark.parametrize("B,L", [(8, 2048), (8, 1280), (8, 512)])
def test_k8_matches_the_plain_scan_in_f32(cuda, B, L):
    """The cell's buckets (batches of 8, the largest 2,048), f32."""
    h, P, g, N = NANO
    args = scan_inputs(B, L, h, P, g, N, seed=L, cut=L - 166, device=cuda)
    with torch.no_grad():
        want = dec.ssd_scan(*args, chunk=128)
        got = fused_ssd_scan(*args, 128)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.isfinite(got).all()
    assert _gap(got, want) <= 1e-6


def test_k8_is_as_close_to_f64_as_the_plain_scan(cuda):
    """Two documents of 2,048 positions (the second zero past 1,500) with
    dt three times the init's: the strongest heads' decays run past -800
    a chunk."""
    h, P, g, N = NANO
    args = scan_inputs(2, 2048, h, P, g, N, seed=26, cut=1500, device=cuda,
                       dt_scale=3.0)
    x, dt, A = args[:3]
    chunk_decay = float((dt[0, :128] * A).sum(0).min())
    assert chunk_decay < -800, chunk_decay
    real = torch.ones(2, 2048, dtype=torch.bool, device=cuda)
    real[1, 1500:] = False
    with torch.no_grad():
        plain = dec.ssd_scan(*args, chunk=128)
        got = fused_ssd_scan(*args, 128)
        want = ref.ssd_recurrence(*(t.double() for t in args))
    k8_gap, plain_gap = _gap(got, want, real), _gap(plain, want, real)
    assert torch.isfinite(got).all()
    assert k8_gap <= 1.5 * plain_gap, (k8_gap, plain_gap)


@pytest.mark.parametrize("L", [1, 127, 128, 129, 2048])
def test_k8_matches_the_plain_scan_at_edge_lengths(cuda, L):
    """Published widths at 16 heads (2 groups), f32; and the tiny
    config's widths."""
    for h, P, g, N, chunk in ((16, 64, 2, 128, 128), (4, 8, 2, 16, 16)):
        args = scan_inputs(2, L, h, P, g, N, seed=L + P, cut=L // 2 + 1,
                           device=cuda)
        with torch.no_grad():
            want = dec.ssd_scan(*args, chunk=chunk)
            got = fused_ssd_scan(*args, chunk)
        assert got.shape == (2, L, h, P) and torch.isfinite(got).all()
        assert _gap(got, want) <= 1e-6, (L, P)


def test_k8_takes_more_sequences_than_a_second_grid_dim_holds(cuda):
    """33,000 passages of 4 heads in 2 groups at the tiny config's widths:
    132,000 passage-heads and 66,000 passage-groups, each past the 65,535
    blocks of a second grid dim, over three chunks."""
    args = scan_inputs(33000, 40, seed=5, cut=23, device=cuda)
    with torch.no_grad():
        want = dec.ssd_scan(*args, chunk=16)
        got = fused_ssd_scan(*args, 16)
    assert torch.isfinite(got).all()
    assert _gap(got, want) <= 1e-6


def test_k8_reads_the_convolutions_bf16_output_in_place(cuda):
    """x, B and C as ``Mamba2.forward`` takes them from ``ShortConv`` (bf16,
    channel-major views of one (B, channels, L) tensor, position stride 1):
    K8's bf16 output within one bf16 ulp of the plain scan's from the same
    tensors, with 1e-5 of the scale as the floor near zero; at 2,048
    positions (whole chunks) and 1,500 (the last chunk cut)."""
    h, P, g, N = NANO
    Bt, D_, gn = 2, h * P, g * N
    torch.manual_seed(0)
    conv = dec.ShortConv(D_ + 2 * gn, 4, torch.bfloat16, bias=True).to(cuda)
    dec.init_weights(conv, 0.5)
    for L in (2048, 1500):
        xbc = torch.randn(Bt, L, D_ + 2 * gn, device=cuda).to(torch.bfloat16)
        with torch.no_grad():
            xs, b, c = conv(xbc).split([D_, gn, gn], dim=-1)
        x, B, C = (xs.reshape(Bt, L, h, P), b.reshape(Bt, L, g, N),
                   c.reshape(Bt, L, g, N))
        assert x.stride()[1] == 1 and B.stride()[1] == 1
        assert not x.is_contiguous()
        _, dt, A, _, _, D = scan_inputs(Bt, L, h, P, g, N, seed=3,
                                        device=cuda)
        with torch.no_grad():
            want = dec.ssd_scan(x, dt, A, B, C, D, chunk=128).float()
            got = fused_ssd_scan(x, dt, A, B, C, D, 128)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        got = got.float()
        assert torch.isfinite(got).all()
        top = float(want.abs().max())
        mag = torch.maximum(got.abs(), want.abs())
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        bad = (got - want).abs() > torch.maximum(
            ulp, torch.full_like(ulp, 1e-5 * top))
        assert not bad.any(), (L, int(bad.sum()))


def _launches_per_forward(cfg, ids, mask, monkeypatch, cuda):
    """K8's launches in a forward under ``no_grad``, and with autograd on
    (where the layers take the plain scan, counted by a spy)."""
    torch.manual_seed(0)
    with torch.device(cuda):
        model = dec.DecoderModel(cfg)
    dec.init_weights(model, 0.02)
    before = kernel_launches()["ssd_scan"]
    with torch.no_grad():
        out = model(ids, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    off = kernel_launches()["ssd_scan"] - before
    plain, spy = [], dec.ssd_scan
    monkeypatch.setattr(dec, "ssd_scan", lambda *a: plain.append(1)
                        or spy(*a))
    model.requires_grad_(True)
    model(ids, mask)
    on = kernel_launches()["ssd_scan"] - before - off
    return off, on, len(plain)


def test_the_launch_counter_counts_mamba_layers_without_autograd(
        cuda, monkeypatch):
    """A ``tiny_nemotron_h`` forward on the card (``MEM*EME``: 3 Mamba-2
    blocks) launches K8 three times under ``no_grad`` and never with
    autograd on; the published widths' 23 Mamba-2 blocks (the other
    blocks left out, the vocabulary cut) launch it 23 times."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 1024, (2, 150))).to(cuda)
    mask = torch.ones_like(ids)
    mask[1, 90:] = 0
    tiny = DecoderConfig.tiny_nemotron_h(dtype=torch.bfloat16,
                                         param_dtype=torch.bfloat16)
    assert _launches_per_forward(tiny, ids, mask, monkeypatch,
                                 cuda) == (3, 0, 3)
    monkeypatch.undo()
    nano = DecoderConfig.nemotron_3_nano_30b_a3b(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16, vocab_size=1024,
        num_layers=23, hybrid_override_pattern="M" * 23)
    with torch.no_grad():
        torch.manual_seed(0)
        with torch.device(cuda):
            model = dec.DecoderModel(nano)
        dec.init_weights(model, 0.02)
        before = kernel_launches()["ssd_scan"]
        out = model(ids, mask)
        torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert kernel_launches()["ssd_scan"] - before == 23
