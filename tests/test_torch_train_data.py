"""The port's train data path against dhr_tpu's: sampling, collation and the
``TrainLoader``, whose batches must equal the reference's byte for byte
(values, dtypes and shapes) given the same groups and seed."""

import random

import numpy as np
import pytest
import torch

from dhr_tpu.data import collate as jcollate
from dhr_tpu.data import examples as jexamples
from dhr_tpu.data import loader as jloader
from dhr_tpu.data import sampling as jsampling
from dhr_tpu_torch.data import collate as tcollate
from dhr_tpu_torch.data import examples as texamples
from dhr_tpu_torch.data import loader as tloader
from dhr_tpu_torch.data import sampling as tsampling

VOCAB = 500


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corpus_rows(rng, n=60):
    return [(str(i), rng.integers(3, VOCAB, rng.integers(1, 20)).tolist())
            for i in range(n)]


def pid_groups(rng, n=24, kd=False):
    out = []
    for _ in range(n):
        g = {"query": rng.integers(3, VOCAB, rng.integers(2, 12)).tolist(),
             "positive_pids": rng.integers(0, 60, rng.integers(1, 3))
             .tolist(),
             "negative_pids": rng.integers(0, 60, rng.integers(2, 9))
             .tolist()}
        if kd:  # bin sets -> bins -> (pos index, neg index, margin)
            g["bin_pairs"] = [[[[int(rng.integers(len(g["positive_pids"]))),
                                 int(rng.integers(len(g["negative_pids"]))),
                                 float(rng.random())] for _ in range(3)]
                               for _ in range(2)] for _ in range(2)]
        out.append(g)
    return out


def inline_groups(rng, n=24):
    return [{"query": rng.integers(3, VOCAB, rng.integers(2, 12)).tolist(),
             "positives": [rng.integers(3, VOCAB, rng.integers(1, 20))
                           .tolist()],
             "negatives": [rng.integers(3, VOCAB, rng.integers(1, 20))
                           .tolist() for _ in range(rng.integers(1, 7))]}
            for _ in range(n)]


def assert_same(got, want, where=""):
    assert type(got) is type(want) or (
        isinstance(got, dict) and isinstance(want, dict)), where
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def loaders(mode, tmp_path):
    rng = np.random.default_rng(0)
    rows = corpus_rows(rng)
    path = tmp_path / "corpus.jsonl"
    texamples.write_jsonl(str(path), ({"text_id": i, "text": t}
                                      for i, t in rows))
    kw = dict(batch_size=5)
    if mode == "plain":
        groups = inline_groups(rng)
    else:
        groups = pid_groups(rng, kd=mode == "kd")
    out = []
    for pkg_loader, pkg_sampling, pkg_examples in (
            (jloader, jsampling, jexamples), (tloader, tsampling, texamples)):
        cfg = pkg_sampling.SamplingConfig(n_passages=4, q_max_len=8,
                                          p_max_len=16, seed=7, cls_id=1,
                                          sep_id=2)
        extra = {}
        if mode != "plain":
            extra["corpus"] = pkg_examples.Corpus.load(str(path))
        if mode == "kd":
            extra["kd"] = True
        if mode == "tasb":
            extra["tasb"] = pkg_sampling.TASBSampler(
                [{"qidx": list(range(i, 24, 4))} for i in range(4)], seed=7)
        if mode == "packed":
            extra.update(pack_passages=True, pack_segments=3)
        out.append(pkg_loader.TrainLoader(groups, cfg, **kw, **extra))
    return out


@pytest.mark.parametrize("mode", ["plain", "kd", "tasb", "packed"])
def test_loader_batches_equal_reference(mode, tmp_path):
    want_loader, got_loader = loaders(mode, tmp_path)
    assert got_loader.steps_per_epoch() == want_loader.steps_per_epoch()
    skip = 2 if mode == "packed" else 0
    for epoch in range(2):
        want = list(want_loader.epoch(epoch, skip=skip))
        got = list(got_loader.epoch(epoch, skip=skip))
        assert len(got) == len(want) == want_loader.steps_per_epoch() - skip
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{mode} epoch {epoch} batch {i}")
        assert got_loader.global_step == want_loader.global_step
    if mode == "packed":
        assert got_loader.pack_rows == want_loader.pack_rows
        assert "packed_passage" in got[0]
    if mode == "kd":
        assert "teacher_scores" in got[0]


def test_skip_gives_the_uninterrupted_batches(tmp_path):
    _, got_loader = loaders("plain", tmp_path)
    full = list(got_loader.epoch(1))
    resumed = list(got_loader.epoch(1, skip=3))
    for g, w in zip(resumed, full[3:]):
        assert_same(g, w)


@pytest.mark.parametrize("cls_sep", [(None, None), (1, 2)])
def test_collate_train_and_packed(cls_sep):
    rng = np.random.default_rng(3)
    ex = [(rng.integers(3, VOCAB, rng.integers(0, 12)).tolist(),
           [rng.integers(3, VOCAB, rng.integers(0, 20)).tolist()
            for _ in range(3)],
           rng.random(2).tolist()) for _ in range(4)]
    cls_id, sep_id = cls_sep
    assert_same(tcollate.collate_train(ex, 8, 16, 0, cls_id, sep_id),
                jcollate.collate_train(ex, 8, 16, 0, cls_id, sep_id))
    no_scores = [(q, ps, None) for q, ps, _ in ex]
    assert_same(tcollate.collate_train(no_scores, 8, 16),
                jcollate.collate_train(no_scores, 8, 16))
    for rows in (12, 2):  # 2 rows: the one-passage-a-row fallback
        got = tcollate.collate_train_packed(ex, 8, 16, rows, 3, 0, cls_id,
                                            sep_id)
        assert_same(got, jcollate.collate_train_packed(
            ex, 8, 16, rows, 3, 0, cls_id, sep_id))
        pp = got["packed_passage"]
        assert sorted(pp["slot_pos"].tolist()) == sorted(set(
            pp["slot_pos"].tolist()))


def test_sampling_functions():
    rng = np.random.default_rng(4)
    for pkg in (tsampling, jsampling):
        assert pkg.truncate([1, 2, 3], 2) == [1, 2]
    negs = list(range(10))
    for epoch in range(4):
        for item in range(5):
            for flags in ({}, {"positive_no_shuffle": True},
                          {"negative_no_shuffle": True}, {"n_passages": 1},
                          {"n_passages": 20}):
                t = tsampling.SamplingConfig(**flags)
                j = jsampling.SamplingConfig(**flags)
                got = tsampling.select_passages([5, 6, 7], negs, item, epoch,
                                                t, random.Random(item))
                want = jsampling.select_passages([5, 6, 7], negs, item,
                                                 epoch, j,
                                                 random.Random(item))
                assert got == want
    rows = corpus_rows(rng)
    tc = texamples.Corpus([i for i, _ in rows], [t for _, t in rows])
    jc = jexamples.Corpus([i for i, _ in rows], [t for _, t in rows])
    assert tc.text_by_pid("7") == jc.text_by_pid(7) == rows[7][1]
    g = pid_groups(rng, 1, kd=True)[0]
    cfg_t, cfg_j = tsampling.SamplingConfig(), jsampling.SamplingConfig()
    assert tsampling.sample_train_example(g, 3, 1, cfg_t, random.Random(1),
                                          tc) == \
        jsampling.sample_train_example(g, 3, 1, cfg_j, random.Random(1), jc)
    assert tsampling.sample_kd_example(g, cfg_t, random.Random(2), tc) == \
        jsampling.sample_kd_example(g, cfg_j, random.Random(2), jc)
    clusters = [{"qidx": [1, 2, 3]}, {"qidx": [4, 5]}]
    assert tsampling.TASBSampler(clusters, 3).batch_indices(5, 7) == \
        jsampling.TASBSampler(clusters, 3).batch_indices(5, 7)


def test_group_and_vector_readers(tmp_path):
    rows = [{"query": [1, 2], "positives": [[3]], "negatives": [[4]]}]
    texamples.write_jsonl(str(tmp_path / "g.jsonl"), rows)
    assert texamples.load_train_groups(str(tmp_path / "g.jsonl")) == \
        jexamples.load_train_groups(str(tmp_path / "g.jsonl")) == rows
    vecs = [{"id": 5, "vector": {"a": 1.5}}, {"id": "x", "vector": {}}]
    texamples.write_jsonl(str(tmp_path / "v.jsonl"), vecs)
    assert list(texamples.load_sparse_vectors(str(tmp_path / "v.jsonl"))) \
        == list(jexamples.load_sparse_vectors(str(tmp_path / "v.jsonl")))
