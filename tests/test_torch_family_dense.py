"""The dense family (CLS and mean pooling, a projection) trained with the
in-graph ColBERT teacher (``train --tct --teacher-path``) by the port,
then both packages' ``encode`` -> ``index`` -> ``search --IP`` ->
``eval`` from the port's export on the CPU (tiny width; see
``tests/torch_family_util.py``)."""

import pytest
import torch

from tests import torch_family_util as fu


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", ["dense_cls", "dense_mean"])
def test_dense_chain_matches_reference(tmp_path, capsys, variant):
    paths = fu.write_world(tmp_path)
    export = fu.train(tmp_path, paths, variant,
                      ["--tct", "--teacher-path", fu.colbert_teacher(tmp_path)])
    metrics = fu.check_chains(tmp_path, paths, variant, export,
                              {"ip": ["--IP"]}, capsys)
    assert 0.0 <= metrics["ip"]["MRR@10"] <= 1.0


def test_dense_loss_reads_no_teacher_scores():
    """The reference's dense loss is the one-hot KL whatever the teacher
    gives (``compute_loss`` passes no teacher to it), so ``--tct`` runs
    the ColBERT teacher and the step ignores its scores; the port keeps
    that answer.  Both packages, the same numpy reps."""
    import jax.numpy as jnp
    import numpy as np

    from dhr_tpu.models.retrievers import Reps as JaxReps
    from dhr_tpu.models.retrievers import RetrieverConfig as JaxCfg
    from dhr_tpu.train.step import LossConfig as JaxLossConfig
    from dhr_tpu.train.step import compute_loss as jax_loss
    from dhr_tpu_torch.models.retrievers import Reps, RetrieverConfig
    from dhr_tpu_torch.train.step import LossConfig, compute_loss

    rng = np.random.default_rng(3)
    q, p = (rng.standard_normal((n, 16)).astype(np.float32) for n in (2, 6))
    teacher = rng.standard_normal((2, 6)).astype(np.float32)
    got = [compute_loss(RetrieverConfig(model_type="dense"),
                        LossConfig(n_passages=3, use_tct_teacher=True),
                        Reps(dense=torch.from_numpy(q)),
                        Reps(dense=torch.from_numpy(p)), t)[0].item()
           for t in (None, torch.from_numpy(teacher))]
    want = [float(jax_loss(JaxCfg(model_type="dense"),
                           JaxLossConfig(n_passages=3, use_tct_teacher=True),
                           JaxReps(dense=jnp.asarray(q)),
                           JaxReps(dense=jnp.asarray(p)), t)[0])
            for t in (None, jnp.asarray(teacher))]
    assert got[0] == got[1] and want[0] == want[1]
    np.testing.assert_allclose(got, want, rtol=1e-6)
