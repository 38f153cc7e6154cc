"""Aggretriever (full fold with the sign competition, semi fold, skip-MLM
scatter-max) trained with margin-KD from ``bin_pairs`` (``train --kd``)
by the port, then both packages' ``encode`` -> ``index`` -> ``search
--IP`` -> ``eval`` from the port's export on the CPU (tiny width; see
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


@pytest.mark.parametrize("variant", ["agg_full", "agg_semi",
                                     "agg_skip_mlm"])
def test_agg_chain_matches_reference(tmp_path, capsys, variant):
    paths = fu.write_world(tmp_path)
    export = fu.train(tmp_path, paths, variant, ["--kd"])
    metrics = fu.check_chains(tmp_path, paths, variant, export,
                              {"ip": ["--IP"]}, capsys)
    assert 0.0 <= metrics["ip"]["MRR@10"] <= 1.0
