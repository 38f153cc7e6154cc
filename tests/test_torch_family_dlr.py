"""The DLR family (lexical-only planes, ``lex_dim == D``) through the
port's ``train`` and both packages' ``encode`` -> ``index --quantize
--lex-dim`` -> ``search`` (GIP at theta 0, and at theta 0.3 with rerank)
-> ``eval`` on the CPU (tiny width; see ``tests/torch_family_util.py``)."""

import pytest
import torch

from tests import torch_family_util as fu


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dlr_chain_matches_reference(tmp_path, capsys):
    paths = fu.write_world(tmp_path)
    export = fu.train(tmp_path, paths, "dlr")
    metrics = fu.check_chains(
        tmp_path, paths, "dlr", export,
        {"theta0": ["--theta", "0"],
         "theta0.3_rerank": ["--theta", "0.3", "--rerank"]}, capsys)
    assert set(metrics) == {"theta0", "theta0.3_rerank"}
