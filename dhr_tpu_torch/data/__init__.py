"""Interchange JSONL I/O and encode-batch collation."""

from dhr_tpu_torch.data.collate import (
    collate_encode,
    pad_token_batch,
    wrap_specials,
)
from dhr_tpu_torch.data.examples import (
    load_tokenized_corpus,
    read_jsonl,
    write_jsonl,
)

__all__ = [
    "collate_encode", "load_tokenized_corpus", "pad_token_batch",
    "read_jsonl", "wrap_specials", "write_jsonl",
]
