"""BEIR zero-shot evaluation over local BEIR dataset directories.

Port of ``dhr_tpu/eval/beir.py`` (the reference's BEIR wrapper stack:
tevatron/datasets/beir/preprocess.py + encode_and_retrieval.py): load a
dataset directory, tokenize, encode corpus and queries, search on the
device, then NDCG / Recall / R_cap at 10 and 100
(encode_and_retrieval.py:66-71).

Dataset layout (the standard BEIR unzip):
  <dir>/corpus.jsonl   {"_id", "title", "text"}
  <dir>/queries.jsonl  {"_id", "text"}
  <dir>/qrels/<split>.tsv  query-id \\t corpus-id \\t score  (header allowed)

The self-hit filter (drop docid == qid) is applied before the metrics, as
the reference does (gip_retrieval.py:340): it matters on corpora whose
queries are drawn from the collection (arguana, quora).

Nothing is fetched from the network: :func:`download_beir_dataset` reuses
an extracted directory or unzips a zip already in the download directory.
:func:`evaluate_beir` records its stages as ``beir.*`` spans of
:mod:`dhr_tpu_torch.utils.profiling`.
"""

from __future__ import annotations

import csv
import json
import logging
import os

from dhr_tpu_torch.data.collate import collate_encode, wrap_specials
from dhr_tpu_torch.eval.metrics import ndcg_at_k, recall_at_k, recall_cap_at_k
from dhr_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

# the canonical public BEIR bucket (reference preprocess.py:22)
BEIR_URL = (
    "https://public.ukp.informatik.tu-darmstadt.de/thakur/BEIR/datasets/"
    "{}.zip"
)

# the 13-dataset zero-shot suite the reference README reports averages over
BEIR_13 = (
    "trec-covid", "nfcorpus", "nq", "hotpotqa", "fiqa", "arguana",
    "webis-touche2020", "quora", "dbpedia-entity", "scidocs", "fever",
    "climate-fever", "scifact",
)


def download_beir_dataset(
    name: str, download_dir: str, url_template: str = BEIR_URL
) -> str:
    """The extracted directory of one BEIR dataset, offline.

    An extracted ``<download_dir>/<name>`` is reused; else
    ``<download_dir>/<name>.zip`` is unzipped.  Without either it raises:
    the port opens no connection (the reference downloads the zip from
    ``url_template`` here).
    """
    out_dir = os.path.join(download_dir, name)
    if os.path.exists(os.path.join(out_dir, "corpus.jsonl")):
        logger.info("BEIR dataset %s already present at %s", name, out_dir)
        return out_dir
    os.makedirs(download_dir, exist_ok=True)
    zip_path = os.path.join(download_dir, f"{name}.zip")
    if not os.path.exists(zip_path):
        url = url_template.format(name)
        raise RuntimeError(
            f"could not download BEIR dataset '{name}' from {url} (the "
            f"network fetch is not ported to dhr_tpu_torch); if this host "
            f"has no network access, place the zip at {zip_path} or the "
            f"unzipped dataset at {out_dir}")
    import zipfile

    with zipfile.ZipFile(zip_path) as z:
        z.extractall(download_dir)
    if not os.path.exists(os.path.join(out_dir, "corpus.jsonl")):
        raise RuntimeError(
            f"unzipped {zip_path} but {out_dir}/corpus.jsonl is missing — "
            "unexpected archive layout"
        )
    return out_dir


def load_beir_dir(path: str, split: str = "test"):
    """A BEIR dataset directory -> ``(corpus, queries, qrels)``: texts are
    ``title + " " + text``, and only queries with qrels are kept."""
    corpus = {}
    with open(os.path.join(path, "corpus.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            corpus[str(row["_id"])] = " ".join(
                p for p in [row.get("title", ""), row.get("text", "")] if p)
    queries = {}
    with open(os.path.join(path, "queries.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            queries[str(row["_id"])] = row["text"]
    qrels: dict[str, dict[str, int]] = {}
    with open(os.path.join(path, "qrels", f"{split}.tsv"), newline="") as f:
        for parts in csv.reader(f, delimiter="\t"):
            if not parts or parts[0] in ("query-id", "qid"):
                continue
            qid, docid, rel = parts[0], parts[1], int(float(parts[2]))
            qrels.setdefault(qid, {})[docid] = rel
    queries = {q: t for q, t in queries.items() if q in qrels}
    return corpus, queries, qrels


def _tokenize(tokenizer, text: str, max_len: int) -> list[int]:
    return tokenizer.encode(text, add_special_tokens=False,
                            max_length=max_len, truncation=True)


def _tokenize_batches(items: dict[str, str], tokenizer, max_len: int,
                      batch_size: int, cls_id: int | None,
                      sep_id: int | None = None,
                      length_bucketing: bool = False):
    """Encode batches of ``items`` (id -> text) in id order, or, with
    ``length_bucketing``, in length order at bucket lengths (fewer pad
    positions; BEIR results and qrels are keyed by id, never by row)."""
    ids = list(items.keys())
    if length_bucketing:
        from dhr_tpu_torch.encode import bucketed_encode_batches

        toks = [_tokenize(tokenizer, items[i], max_len) for i in ids]
        batches, _ = bucketed_encode_batches(ids, toks, batch_size, max_len,
                                             cls_id, sep_id)
        yield from batches
        return
    for start in range(0, len(ids), batch_size):
        chunk = ids[start: start + batch_size]
        toks = [wrap_specials(_tokenize(tokenizer, items[i], max_len),
                              max_len, cls_id, sep_id) for i in chunk]
        yield collate_encode(chunk, toks, max_len)


def _timed(batches, name: str):
    """``batches``, each one's production a span ``name``."""
    it = iter(batches)
    while True:
        with span(name):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def evaluate_beir(
    encoder,
    search_config,
    dataset_dir: str,
    tokenizer,
    split: str = "test",
    q_max_len: int = 512,
    p_max_len: int = 512,
    cls_id: int | None = 101,
    sep_id: int | None = None,
    device=None,
    k_values=(10, 100),
    length_bucketing: bool = False,
    pack: bool = False,
    pack_segments: int = 8,
    mesh=None,
) -> dict:
    """End-to-end BEIR evaluation of one dataset directory.

    ``encoder`` is a :class:`dhr_tpu_torch.encode.Encoder`,
    ``search_config`` a :class:`dhr_tpu_torch.retrieval.SearchConfig`;
    the index and the searcher live on ``device`` (default: the
    encoder's).  ``mesh``: the index is row-sharded over its ranks (every
    rank calls this with the same arguments; give the encoder the mesh
    too to encode data-parallel).  Spans: ``beir.tokenize`` (inside
    ``beir.encode``), ``beir.encode``, ``beir.index``, ``beir.search``,
    ``beir.metrics``.
    """
    from dhr_tpu_torch.retrieval import DeviceIndex, Searcher

    device = encoder.device if device is None else device
    corpus, queries, qrels = load_beir_dir(dataset_dir, split)
    bs = encoder.encode_cfg.batch_size
    with span("beir.encode"):
        if pack:
            # token packing beats bucketing when documents are much
            # shorter than p_max_len; the corpus is keyed by id
            # downstream, so the plan order never matters here
            from dhr_tpu_torch.encode import packed_encode_batches

            doc_ids = list(corpus.keys())
            with span("beir.tokenize"):
                toks = [_tokenize(tokenizer, corpus[i], p_max_len)
                        for i in doc_ids]
            gen, _ = packed_encode_batches(doc_ids, toks, bs, p_max_len,
                                           pack_segments, cls_id, sep_id)
            packed = encoder.encode_corpus_packed(gen)
        else:
            packed = encoder.encode_corpus(_timed(_tokenize_batches(
                corpus, tokenizer, p_max_len, bs, cls_id, sep_id,
                length_bucketing=length_bucketing), "beir.tokenize"))
        qv, qi, qids = encoder.encode_queries(_timed(_tokenize_batches(
            queries, tokenizer, q_max_len, bs, cls_id, sep_id,
            length_bucketing=length_bucketing), "beir.tokenize"))
    with span("beir.index"):
        index = DeviceIndex.from_packed(packed, device=device, mesh=mesh)
    with span("beir.search"):
        searcher = Searcher(index, search_config, device=device)
        results, scores = searcher.search_run(qids, qv, qi)
    with span("beir.metrics"):
        # self-hit filter, then the metrics
        run = {qid: {d: s for d, s in zip(results[qid], scores[qid])
                     if d != qid}
               for qid in results}
        out = {}
        for k in k_values:
            out[f"NDCG@{k}"] = ndcg_at_k(qrels, run, k)
            out[f"Recall@{k}"] = recall_at_k(qrels, run, k)
            out[f"R_cap@{k}"] = recall_cap_at_k(qrels, run, k)
        out["num_queries"] = len(qids)
    return out
