"""Token-id traffic: passage and query lengths, Zipf wordpiece ids, and text
queries with the hashing word tokenizer that turns them into ids.

Everything is a function of a seed (``np.random.SeedSequence`` words, so
any non-negative seed works) and of a length spec from a traffic file::

    {"mean": 75, "sigma": 0.45, "min": 8, "max": 126}

a log-normal number of content tokens with that mean, rounded and clipped
to ``[min, max]`` (the [CLS] / [SEP] pair comes on top at collation).
"""

from __future__ import annotations

import math
import zlib

import numpy as np

CONTENT_ID_LO = 1000      # wordpiece ids below are specials and unused slots
VOCAB = 30522
ZIPF_S = 1.0              # Zipf exponent of wordpiece frequencies


def rng(*words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(w) % (1 << 64) for w in words]))


def lengths(spec: dict, n: int, r: np.random.Generator) -> np.ndarray:
    """``n`` content-token counts from a log-normal length spec."""
    s = float(spec["sigma"])
    mu = math.log(float(spec["mean"])) - s * s / 2
    out = np.rint(r.lognormal(mu, s, n))
    return np.clip(out, spec["min"], spec["max"]).astype(np.int64)


def zipf_ids(n: int, r: np.random.Generator, vocab: int = VOCAB,
             lo: int = CONTENT_ID_LO) -> np.ndarray:
    """``n`` wordpiece ids in ``[lo, vocab)``, Zipf by rank (id ``lo + k``
    has rank ``k``)."""
    ranks = np.arange(1, vocab - lo + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -ZIPF_S)
    cdf /= cdf[-1]
    return lo + np.minimum(np.searchsorted(cdf, r.random(n)),
                           vocab - lo - 1).astype(np.int32)


def token_lists(spec: dict, n: int, r: np.random.Generator,
                vocab: int = VOCAB, lo: int = CONTENT_ID_LO):
    """``n`` token-id arrays (views of one draw) and their lengths."""
    lens = lengths(spec, n, r)
    flat = zipf_ids(int(lens.sum()), r, vocab, lo)
    ends = np.cumsum(lens)
    return np.split(flat, ends[:-1]), lens


# -- text queries ---------------------------------------------------------

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def word_list(n_words: int, r: np.random.Generator) -> list[str]:
    """A vocabulary of ``n_words`` distinct lower-case words of 2-10
    letters."""
    words, seen = [], set()
    while len(words) < n_words:
        k = int(r.integers(2, 11))
        w = "".join(LETTERS[i] for i in r.integers(0, 26, k))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def text_queries(spec: dict, n: int, r: np.random.Generator,
                 n_words: int = 50_000) -> list[str]:
    """``n`` queries of ``spec``-distributed word counts, words drawn
    Zipf-wise from a seeded vocabulary."""
    words = word_list(n_words, r)
    lens = lengths(spec, n, r)
    ranks = zipf_ids(int(lens.sum()), r, vocab=n_words, lo=0)
    out, s = [], 0
    for k in lens:
        out.append(" ".join(words[i] for i in ranks[s:s + k]))
        s += k
    return out


class HashingTokenizer:
    """Words to wordpiece-range ids by a CRC32 hash: lower-cased,
    whitespace-split, id ``CONTENT_ID_LO + crc32(word) % (vocab -
    CONTENT_ID_LO)``.  ``encode`` has the signature the program's query
    encoder calls (``add_special_tokens``, ``max_length``, ``truncation``)."""

    def __init__(self, vocab: int = VOCAB, lo: int = CONTENT_ID_LO):
        self.vocab, self.lo = vocab, lo

    def encode(self, text: str, add_special_tokens: bool = False,
               max_length: int | None = None,
               truncation: bool = False) -> list[int]:
        if add_special_tokens:
            raise ValueError("the hashing tokenizer adds no specials")
        ids = [self.lo + zlib.crc32(w.encode()) % (self.vocab - self.lo)
               for w in text.lower().split()]
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return ids
