"""Interchange JSONL I/O, sampling, collation and the train loader."""

from dhr_tpu_torch.data.collate import (
    collate_encode,
    collate_train,
    collate_train_packed,
    pad_token_batch,
    wrap_specials,
)
from dhr_tpu_torch.data.examples import (
    Corpus,
    load_sparse_vectors,
    load_tokenized_corpus,
    load_train_groups,
    read_jsonl,
    write_jsonl,
)
from dhr_tpu_torch.data.loader import TrainLoader
from dhr_tpu_torch.data.sampling import (
    SamplingConfig,
    TASBSampler,
    sample_kd_example,
    sample_train_example,
    select_passages,
)

__all__ = [
    "Corpus", "SamplingConfig", "TASBSampler", "TrainLoader",
    "collate_encode", "collate_train", "collate_train_packed",
    "load_sparse_vectors", "load_tokenized_corpus", "load_train_groups",
    "pad_token_batch", "read_jsonl", "sample_kd_example",
    "sample_train_example", "select_passages", "wrap_specials",
    "write_jsonl",
]
