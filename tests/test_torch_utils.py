"""The port's ``utils``: the converters against ``dhr_tpu.utils`` (byte for
byte), the DPR checkpoint split, phase timing and the profiler trace."""

import json
import os
import time

import pytest
import torch

from dhr_tpu.utils import convert as ref
from dhr_tpu_torch import utils
from dhr_tpu_torch.utils import profiling


def test_convert_ranking_to_trec_byte_equal(tmp_path):
    src = tmp_path / "rank.tsv"
    src.write_text("q1\td2\t1.5\nq1\td1\t2.5\nq2\td9\t-1\nq1\td0\t2.5\n"
                   "short\trow\nq2\td3\t0.25\textra\n")
    utils.convert_ranking_to_trec(str(src), str(tmp_path / "got"), "run")
    ref.convert_ranking_to_trec(str(src), str(tmp_path / "want"), "run")
    got = (tmp_path / "got").read_bytes()
    assert got == (tmp_path / "want").read_bytes()
    assert got.decode().splitlines()[:2] == ["q1 Q0 d0 1 2.5 run",
                                             "q1 Q0 d1 2 2.5 run"]


def test_tsv_readers_match_reference(tmp_path):
    pairs = tmp_path / "pairs.tsv"
    pairs.write_text("a\tfirst text\nb\tsecond\textra\nlonely\n\na\tagain\n")
    assert utils.read_tsv_pairs(str(pairs)) == ref.read_tsv_pairs(
        str(pairs)) == {"a": "again", "b": "second"}
    qrels = tmp_path / "qrels.tsv"
    qrels.write_text("q1\t0\td1\t1\nq1\t0\td2\t0\nq2\t0\td1\t2\n"
                     "q3\td1\t1\n")
    got = utils.read_qrel_tsv(str(qrels))
    assert got == ref.read_qrel_tsv(str(qrels))
    assert got == {"q1": {"d1": 1, "d2": 0}, "q2": {"d1": 2}}


@pytest.mark.parametrize("wrapped,config", [(True, {"hidden_size": 8}),
                                            (False, None)])
def test_convert_dpr_checkpoint_splits_the_two_towers(tmp_path, wrapped,
                                                      config):
    g = torch.Generator().manual_seed(0)
    sd = {"question_model.embeddings.weight": torch.randn(5, 4, generator=g),
          "question_model.pooler.bias": torch.randn(4, generator=g),
          "ctx_model.embeddings.weight": torch.randn(5, 4, generator=g),
          "other.weight": torch.randn(2, generator=g)}
    path = str(tmp_path / "dpr.pt")
    torch.save({"model_dict": sd, "epoch": 3} if wrapped else sd, path)
    utils.convert_dpr_checkpoint(path, str(tmp_path / "got"), config)
    ref.convert_dpr_checkpoint(path, str(tmp_path / "want"), config)
    for sub, prefix in (("query_model", "question_model."),
                        ("passage_model", "ctx_model.")):
        got = torch.load(tmp_path / "got" / sub / "pytorch_model.bin")
        want = torch.load(tmp_path / "want" / sub / "pytorch_model.bin")
        assert sorted(got) == sorted(want) == sorted(
            k[len(prefix):] for k in sd if k.startswith(prefix))
        for k in got:
            assert torch.equal(got[k], want[k])
            assert torch.equal(got[k], sd[prefix + k])
        cfg = tmp_path / "got" / sub / "config.json"
        assert cfg.exists() == (config is not None)
        if config is not None:
            assert cfg.read_bytes() == (
                tmp_path / "want" / sub / "config.json").read_bytes()
            assert json.loads(cfg.read_text()) == config


def test_phase_report_reset():
    profiling.reset()
    for _ in range(2):
        with profiling.phase("a"):
            time.sleep(0.01)
    with pytest.raises(ValueError):
        with profiling.phase("b", log=True):
            raise ValueError("timed all the same")
    rep = profiling.report()
    assert sorted(rep) == ["a", "b"]
    assert rep["a"]["count"] == 2 and rep["a"]["total_s"] >= 0.02
    assert rep["a"]["mean_s"] == pytest.approx(rep["a"]["total_s"] / 2)
    assert rep["b"]["count"] == 1
    profiling.reset()
    assert profiling.report() == {}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with utils.trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


def test_train_profile_dir_writes_its_trace_through_trace(tmp_path):
    """``run_training(profile_dir=...)`` profiles the run with ``trace``."""
    from tests.test_torch_train_driver import run

    run(tmp_path, "p", num_epochs=1, max_steps=2,
        profile_dir=str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
