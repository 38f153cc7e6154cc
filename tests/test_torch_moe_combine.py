"""The MoE layer's combine (``ops/moe_combine.py``) on the CPU.

The plain version, ``combine``, is the decoder's eager combine: gather each
token's ``k`` rows, weight them in f32, sum over ``k``, cast back.  On the
CPU the wrapper ``moe_combine`` routes to it bit for bit and launches
nothing; it refuses what the CUDA kernel does not take, on any device.
The decoder's grouped path takes the wrapper where autograd records
nothing and the eager ``combine`` otherwise.  The CUDA kernel is held
against the plain version on the card in ``tests/test_torch_kernels.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.moe_combine import combine, moe_combine
from dhr_tpu_torch.utils import profiling

# the module (the package's attribute of that name is the wrapper)
mc = importlib.import_module("dhr_tpu_torch.ops.moe_combine")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(N, k, H, dtype, seed=0):
    """Rows in expert order (N * k, H), ``slot`` a random permutation of
    them (N, k), and weights with zeros and negatives."""
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.normal(0, 1, (N * k, H)).astype(np.float32))
    slot = torch.from_numpy(rng.permutation(N * k).reshape(N, k))
    w = rng.uniform(-0.5, 1.0, (N, k)).astype(np.float32)
    w[::3, 0] = 0.0
    return rows.to(dtype), slot, torch.from_numpy(w)


def _f64_bound(rows, slot, w, dtype):
    """The f64 sum and how far an f32 sum in any order, rounded to
    ``dtype``, may lie from it: an ulp of ``dtype`` at the sum (its
    subnormals' spacing below the normal range), and the f32 sum's
    round-off, k * 2^-24 of the sum of the products' magnitudes."""
    x = rows.double()[slot]                        # (N, k, H)
    prod = x * w.double()[..., None]
    ref = prod.sum(dim=1)
    fi = torch.finfo(dtype)
    _, exp = torch.frexp(ref.abs().float())
    ulp = (torch.ldexp(torch.ones_like(ref), exp - 1) * fi.eps).clamp_min(
        fi.tiny * fi.eps)
    k = slot.shape[1]
    return ref, ulp + k * 2.0 ** -24 * prod.abs().sum(dim=1)


# (N, k, H)
CASES = {
    "no_tokens": (0, 6, 64),
    "one_token": (1, 6, 64),
    "one_slot": (9, 1, 64),
    "two_slots": (9, 2, 64),
    "dsv2_k": (13, 6, 128),
    "odd_hidden": (7, 6, 61),
    "most_slots": (5, 16, 40),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_combine_is_the_weighted_sum(case, dtype):
    """Through the wrapper on the CPU: ``combine`` bit for bit, no launch
    counted, and within an ulp of ``dtype`` of the f64 sum (plus the f32
    sum's round-off)."""
    N, k, H = CASES[case]
    rows, slot, w = _inputs(N, k, H, dtype)
    profiling.reset()
    got = moe_combine(rows, slot, w)
    want = combine(rows, slot, w)
    assert got.shape == (N, H) and got.dtype == dtype
    assert torch.equal(got, want)
    assert kernel_launches()["moe_combine"] == 0
    ref, tol = _f64_bound(rows, slot, w, dtype)
    assert ((got.double() - ref).abs() <= tol).all()


def _bad(kind):
    rows, slot, w = _inputs(4, 6, 16, torch.bfloat16)
    if kind == "rows_rank":
        rows = rows[None]
    elif kind == "slot_rank":
        slot = slot.reshape(-1)
    elif kind == "weights_shape":
        w = w[:, :5]
    elif kind == "k_over_16":
        rows, slot, w = _inputs(2, 17, 16, torch.bfloat16)
    elif kind == "k_zero":
        slot, w = slot[:, :0], w[:, :0]
    elif kind == "no_rows":
        rows = rows[:0]
    elif kind == "rows_dtype":
        rows = rows.to(torch.int32)
    elif kind == "slot_dtype":
        slot = slot.to(torch.int32)
    elif kind == "weights_dtype":
        w = w.double()
    elif kind == "rows_strided":
        rows = rows.t().contiguous().t()
    elif kind == "slot_strided":
        slot = slot.t().contiguous().t()
    elif kind == "weights_strided":
        w = w.t().contiguous().t()
    elif kind == "mixed_devices":
        w = w.to("meta")
    elif kind == "other_device":
        rows, slot, w = (t.to("meta") for t in (rows, slot, w))
    return rows, slot, w


@pytest.mark.parametrize("kind", [
    "rows_rank", "slot_rank", "weights_shape", "k_over_16", "k_zero",
    "no_rows", "rows_dtype", "slot_dtype", "weights_dtype", "rows_strided",
    "slot_strided", "weights_strided", "mixed_devices", "other_device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind):
    with pytest.raises((ValueError, TypeError)):
        moe_combine(*_bad(kind))


def _spy(monkeypatch):
    """Record which combine the grouped path calls, and where the wrapper
    routes a CPU tensor ("cpu": to its plain version)."""
    calls = []

    def spy(name, module, attr):
        real = getattr(module, attr)

        def call(*a):
            calls.append(name)
            return real(*a)

        monkeypatch.setattr(module, attr, call)

    spy("combine", dec, "combine")
    spy("moe_combine", dec, "moe_combine")
    spy("cpu", mc, "combine")
    return calls


@pytest.mark.parametrize("grad,requires", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_grouped_path_combines_through_the_kernel_without_autograd(
        grad, requires, monkeypatch):
    """The grouped path takes ``moe_combine`` (K5 on the card; a CPU
    tensor goes on to ``combine``) unless autograd records the combine;
    then the eager ``combine``, which autograd differentiates.  The same
    bits either way."""
    torch.manual_seed(0)
    E, H, F_, k, N = 8, 32, 16, 2, 37
    experts = dec.Experts(E, H, F_, torch.float32)
    dec.init_weights(experts, 0.2)
    experts.requires_grad_(requires)
    x = torch.randn(N, H)
    idx, w = dec.route(x, torch.randn(E, H) * 0.5, k)
    with torch.no_grad():
        want = dec.routed_experts_grouped(x, idx, w, experts)
    calls = _spy(monkeypatch)
    with torch.set_grad_enabled(grad):
        got = dec.routed_experts_grouped(x, idx, w, experts)
    records = grad and requires
    assert calls == (["combine"] if records else ["moe_combine", "cpu"])
    assert got.requires_grad == records
    assert torch.equal(got.detach(), want)
    if records:
        got.sum().backward()
        assert experts.down_proj.grad.abs().sum() > 0
