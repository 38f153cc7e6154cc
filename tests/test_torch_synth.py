"""The port's synthetic generator against dhr_tpu's, statistically (the
jax.random streams cannot be reproduced), plus its own determinism."""

import jax
import numpy as np
import pytest
import torch

from dhr_tpu.retrieval.synth import SynthConfig as JaxSynthConfig
from dhr_tpu.retrieval.synth import synth_reps as jax_synth_reps
from dhr_tpu_torch.ops.quantize import quantize_with_scales
from dhr_tpu_torch.retrieval.synth import (
    SynthConfig,
    synth_index_planes,
    synth_reps,
)


def test_config_defaults_match_reference():
    import dataclasses

    assert dataclasses.asdict(SynthConfig()) == \
        dataclasses.asdict(JaxSynthConfig())


def test_query_dims_above_theta_in_calibrated_band():
    """~30-46 query dims clear theta=0.3 in both generators (the band the
    reference calibrated, synth.py:10-13); folds lie in [0, 39)."""
    n = 4096
    qv, qf, _ = synth_reps(0, n, role="query", stream=1, device="cpu")
    jv, jf, _ = jax_synth_reps(jax.random.PRNGKey(0), n, JaxSynthConfig(),
                               "query", stream=1)
    port = (qv[:, :768] > 0.3).sum(1).float().mean().item()
    ref = float((np.asarray(jv)[:, :768] > 0.3).sum(1).mean())
    assert 30 <= port <= 46 and 30 <= ref <= 46, (port, ref)
    assert abs(port - ref) <= 4
    assert qv.shape == (n, 896) and qf.dtype == torch.int8
    assert int(qf.min()) >= 0 and int(qf.max()) < 39
    jf = np.asarray(jf)
    assert jf.min() >= 0 and jf.max() < 39


def test_index_planes_chunked_and_deterministic():
    """Any row count (a short last chunk); the quantize pass regenerates
    the amax pass's chunks, so both calls agree and the int8 plane is the
    quantization of the regenerated values."""
    a = synth_index_planes(3, 2500, chunk_rows=1024, device="cpu")
    b = synth_index_planes(3, 2500, chunk_rows=1024, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    v_i8, folds, scales, _ = a
    assert v_i8.shape == (2500, 896) and folds.shape == (2500, 768)
    assert int(v_i8.abs().max()) == 127
    # passages: ~140 materially active dims (value > 0.05) per row
    deq = v_i8.float() * scales
    active = (deq[:, :768] > 0.05).sum(1).float().mean().item()
    assert 100 <= active <= 180, active
    # the first chunk regenerated on its own quantizes to the same rows
    from dhr_tpu_torch.retrieval.synth import (
        _chunk_reps, _generator, make_world)

    world = make_world(SynthConfig(), 3, torch.device("cpu"))
    values, f, _ = _chunk_reps(SynthConfig(), world,
                               _generator(torch.device("cpu"), 3, 0, 0),
                               1024, "passage")
    assert torch.equal(quantize_with_scales(values, scales), v_i8[:1024])
    assert torch.equal(f, folds[:1024])


@pytest.mark.parametrize("span", [(0, 700), (700, 1100), (250, 900)])
def test_index_planes_rows_equal_the_whole_corpus(span):
    """A row range (one rank's shard, pad rows past n) is that slice of the
    whole corpus, scales included; with reduce_amax the amax pass reads
    only the chunks the range touches and the reduce completes it."""
    whole = synth_index_planes(3, 1000, chunk_rows=256, device="cpu")
    start, stop = span
    part = synth_index_planes(3, 1000, chunk_rows=256, device="cpu",
                              rows=span)
    real = min(stop, 1000) - start
    for w, p in zip((whole[0], whole[1], whole[3]),
                    (part[0], part[1], part[3])):
        assert torch.equal(p[:real], w[start:start + real])
        assert not p[real:].any() or p.dtype == torch.long
    assert (part[3][real:] == -1).all()
    assert torch.equal(part[2], whole[2])
    # two ranks covering the corpus: each scans only its chunks, the MAX
    # of their amaxes is the whole corpus's
    halves = [(0, 500), (500, 1000)]
    local_amax = []
    for h in halves:
        synth_index_planes(3, 1000, chunk_rows=256, device="cpu", rows=h,
                           reduce_amax=lambda a: local_amax.append(a) or a)
    both = torch.maximum(*local_amax)
    local = synth_index_planes(3, 1000, chunk_rows=256, device="cpu",
                               rows=span, reduce_amax=lambda a: torch.maximum(
                                   a, both))
    assert torch.equal(local[2], whole[2])
    assert torch.equal(local[0], part[0])
