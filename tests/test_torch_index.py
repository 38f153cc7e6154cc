"""Index state crosses between dhr_tpu and dhr_tpu_torch byte for byte."""

import pickle

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dhr_tpu.ops.quantize import quantize_per_dim as jax_quantize
from dhr_tpu.ops.quantize import quantize_per_dim_np as jax_quantize_np
from dhr_tpu.retrieval.index import DeviceIndex as JaxDeviceIndex
from dhr_tpu.retrieval.index import PackedIndex as JaxPacked
from dhr_tpu_torch.ops.quantize import quantize_per_dim, quantize_per_dim_np
from dhr_tpu_torch.retrieval.index import DeviceIndex, PackedIndex


def _packed(cls, rng, n=37, lex=12, cls_dim=4, fold_hi=6,
            idx_dtype=np.uint8, pq=False):
    values = rng.standard_normal((n, lex + cls_dim)).astype(np.float16)
    indices = rng.integers(0, fold_hi, (n, lex)).astype(idx_dtype)
    docids = np.asarray([f"d{i}" for i in range(n)], dtype=object)
    kw = {}
    if pq:
        kw = dict(pq_codes=rng.integers(0, 256, (n, 4)).astype(np.uint8),
                  pq_centroids=rng.random((4, 256, 4)).astype(np.float32))
    return cls(values, indices, docids, lex, **kw)


def _assert_packed_equal(a, b):
    for f in ("values", "indices", "value_scales", "pq_codes",
              "pq_centroids"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
    assert a.lex_dim == b.lex_dim
    assert list(a.docids) == list(b.docids)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("pq", [False, True])
def test_save_load_roundtrip_both_directions(tmp_path, rng, quantized, pq):
    jp = _packed(JaxPacked, rng, pq=pq)
    if quantized:
        jp = jp.quantize()
    jp.save(str(tmp_path / "jax.npz"))
    tp = PackedIndex.load(str(tmp_path / "jax.npz"))
    _assert_packed_equal(jp, tp)
    tp.save(str(tmp_path / "torch.npz"))
    _assert_packed_equal(JaxPacked.load(str(tmp_path / "torch.npz")), jp)
    assert (tmp_path / "torch.docids.json").read_text() == \
        (tmp_path / "jax.docids.json").read_text()


def test_merge_glob_slice_and_reference_pickle(tmp_path, rng):
    shards = [_packed(JaxPacked, rng, n=n) for n in (5, 9)]
    shards[0].save(str(tmp_path / "s0.npz"))
    with open(tmp_path / "s1.pkl", "wb") as f:
        pickle.dump([shards[1].values, shards[1].indices,
                     list(shards[1].docids)], f)
    pattern = str(tmp_path / "s[0-9].[np]*")  # not the docids sidecar
    want = JaxPacked.merge_glob(pattern)
    got = PackedIndex.merge_glob(pattern)
    _assert_packed_equal(want, got)
    _assert_packed_equal(want.slice_rows(3, 11), got.slice_rows(3, 11))


def test_quantize_matches_reference(rng):
    x = (rng.standard_normal((50, 24)) * rng.random(24) * 3).astype(np.float32)
    x[:, 5] = 0.0  # an all-zero dim keeps scale 1
    q_want, s_want = jax_quantize_np(x)
    q_got, s_got = quantize_per_dim_np(x)
    assert q_got.dtype == np.int8 and q_got.tobytes() == q_want.tobytes()
    assert s_got.tobytes() == s_want.tobytes()
    plane = jax_quantize(jnp.asarray(x))
    qt, st = quantize_per_dim(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(plane.values_i8))
    np.testing.assert_array_equal(st.numpy(), np.asarray(plane.scales))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind not in "iu":
        x = x.view(np.int16)
    return x.tobytes(), x.shape


@pytest.mark.parametrize("layout", ["both", "row", "dim"])
@pytest.mark.parametrize("case", ["float", "int8", "fold_ge_128"])
def test_device_planes_byte_equal(rng, layout, case):
    fold_hi = 200 if case == "fold_ge_128" else 6
    jp = _packed(JaxPacked, rng, fold_hi=fold_hi)
    if case == "int8":
        jp = jp.quantize()
    want = JaxDeviceIndex.from_packed(jp, layout=layout)
    got = DeviceIndex.from_packed(PackedIndex(**vars(jp)), layout=layout,
                                  device="cpu")
    for f in ("values", "values_T", "indices", "indices_T"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            if f.endswith("_T"):   # (D, N) view of padded (D, pitch) rows
                assert g.stride() == (128, 1), f
            else:
                assert g.is_contiguous()
            assert _bytes(g) == _bytes(w), f
    planes = [p for p in (got.indices, got.indices_T) if p is not None]
    if case == "fold_ge_128":
        assert all(p.dtype == torch.int16 for p in planes)
    if case == "int8":
        assert all(p.dtype == torch.int8 for p in (got.values, got.values_T)
                   if p is not None)
        np.testing.assert_array_equal(got.value_scales.numpy(),
                                      np.asarray(want.value_scales))
    assert got.num_rows == want.num_rows and got.dim == want.dim


def test_from_arrays_takes_reference_planes(rng):
    """Planes of a JAX DeviceIndex, pulled out with np.asarray, build the
    same port index as the packed path."""
    jp = _packed(JaxPacked, rng).quantize()
    jidx = JaxDeviceIndex.from_packed(jp)
    got = DeviceIndex.from_arrays(np.asarray(jidx.values),
                                  np.asarray(jidx.indices), jp.docids,
                                  jp.lex_dim, np.asarray(jidx.value_scales),
                                  device="cpu")
    want = DeviceIndex.from_packed(PackedIndex(**vars(jp)), device="cpu")
    for f in ("values", "values_T", "indices", "indices_T", "value_scales"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
