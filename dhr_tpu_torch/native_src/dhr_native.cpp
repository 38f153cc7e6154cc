// dhr_tpu_torch native host runtime (a copy of dhr_tpu's, built under its
// own library name so the two packages never load each other's).
//
// The original system delegates its native work to faiss/Lucene; device
// compute stays in PyTorch and the CUDA kernels, and the *host* hot paths
// live here, exposed over a plain C ABI for ctypes:
//
//   - dhr_load_corpus:  parse tokenized-corpus JSONL ({"text_id", "text":
//     [ids]}) into packed CSR arrays. This is the encode pipeline's host
//     bottleneck at MS MARCO scale (8.8M rows); the Python json module is
//     ~30x slower than this single-pass scanner.
//   - dhr_bm25_df / dhr_bm25_weights: document frequencies and Lucene-flavor
//     BM25 weights over a CSR corpus (replaces pyserini IndexReader's
//     per-term compute_bm25_term_weight loop, reference
//     densify/output_vector.py:24-31).
//   - dhr_densify_csr: fold-max densification of CSR sparse vectors into
//     (value, argmax) planes with collision counting (the reference's
//     per-token Python loop, densify/densify_corpus.py:29-52).
//   - dhr_plan_packing: first-fit-decreasing token-packing planner (the
//     encode --pack twin; one C++ pass instead of an 8.8M-iteration Python
//     loop at corpus scale)
//   - dhr_merge_topk: k-way merge of per-shard (score, id) lists (the faiss
//     ResultHeap role, reference tevatron/faiss_retriever/reducer.py).
//
// Build: g++ -O3 -march=native -shared -fPIC dhr_native.cpp -o libdhr_torch_native.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// tokenized-corpus JSONL parser
// ---------------------------------------------------------------------------

struct DhrCorpus {
  int64_t n_docs;
  int64_t n_tokens;
  char*   ids_buf;        // concatenated doc-id strings
  int64_t ids_len;
  int64_t* id_offsets;    // n_docs + 1
  int32_t* tokens;        // n_tokens
  int64_t* token_offsets; // n_docs + 1
};

static const char* find_key(const char* p, const char* end, const char* key) {
  size_t klen = strlen(key);
  const char* q = p;
  while ((q = (const char*)memmem(q, end - q, key, klen)) != nullptr) {
    return q + klen;
  }
  return nullptr;
}

DhrCorpus* dhr_load_corpus(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(fsize + 1);
  if (fread(buf.data(), 1, fsize, f) != (size_t)fsize) { fclose(f); return nullptr; }
  fclose(f);
  buf[fsize] = '\0';

  auto* out = new DhrCorpus();
  std::vector<char> ids;
  std::vector<int64_t> id_offsets{0};
  std::vector<int32_t> tokens;
  std::vector<int64_t> token_offsets{0};
  tokens.reserve(1 << 20);

  const char* p = buf.data();
  const char* end = p + fsize;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* line_end = nl ? nl : end;
    // "text_id": <string-or-number>
    const char* tid = find_key(p, line_end, "\"text_id\"");
    if (tid) {
      while (tid < line_end && (*tid == ':' || *tid == ' ')) tid++;
      if (*tid == '"') {
        tid++;
        const char* q = tid;
        while (q < line_end && *q != '"') q++;
        ids.insert(ids.end(), tid, q);
      } else {
        const char* q = tid;
        while (q < line_end && *q != ',' && *q != '}') q++;
        ids.insert(ids.end(), tid, q);
      }
      id_offsets.push_back((int64_t)ids.size());
      // "text": [ ... ]
      const char* tx = find_key(p, line_end, "\"text\"");
      if (tx) {
        while (tx < line_end && *tx != '[') tx++;
        tx++;
        long v = 0; bool in_num = false, neg = false;
        for (const char* q = tx; q < line_end && *q != ']'; q++) {
          char c = *q;
          if (c >= '0' && c <= '9') { v = v * 10 + (c - '0'); in_num = true; }
          else if (c == '-') { neg = true; }
          else if (in_num) {
            tokens.push_back((int32_t)(neg ? -v : v));
            v = 0; in_num = false; neg = false;
          }
        }
        if (in_num) tokens.push_back((int32_t)(neg ? -v : v));
      }
      token_offsets.push_back((int64_t)tokens.size());
    }
    if (!nl) break;
    p = nl + 1;
  }

  out->n_docs = (int64_t)id_offsets.size() - 1;
  out->n_tokens = (int64_t)tokens.size();
  out->ids_len = (int64_t)ids.size();
  out->ids_buf = (char*)malloc(ids.size() + 1);
  memcpy(out->ids_buf, ids.data(), ids.size());
  out->ids_buf[ids.size()] = '\0';
  out->id_offsets = (int64_t*)malloc(id_offsets.size() * sizeof(int64_t));
  memcpy(out->id_offsets, id_offsets.data(), id_offsets.size() * sizeof(int64_t));
  out->tokens = (int32_t*)malloc(std::max<size_t>(tokens.size(), 1) * sizeof(int32_t));
  memcpy(out->tokens, tokens.data(), tokens.size() * sizeof(int32_t));
  out->token_offsets = (int64_t*)malloc(token_offsets.size() * sizeof(int64_t));
  memcpy(out->token_offsets, token_offsets.data(),
         token_offsets.size() * sizeof(int64_t));
  return out;
}

void dhr_free_corpus(DhrCorpus* c) {
  if (!c) return;
  free(c->ids_buf);
  free(c->id_offsets);
  free(c->tokens);
  free(c->token_offsets);
  delete c;
}

// ---------------------------------------------------------------------------
// BM25 over a CSR corpus (term ids already mapped to [0, vocab))
// ---------------------------------------------------------------------------

void dhr_bm25_df(const int32_t* tokens, const int64_t* offsets, int64_t n_docs,
                 int32_t vocab, int64_t* df_out, int64_t* total_terms_out) {
  std::vector<int64_t> last_doc(vocab, -1);
  int64_t total = 0;
  for (int64_t d = 0; d < n_docs; d++) {
    for (int64_t j = offsets[d]; j < offsets[d + 1]; j++) {
      int32_t t = tokens[j];
      total++;
      if (t >= 0 && t < vocab && last_doc[t] != d) {
        last_doc[t] = d;
        df_out[t]++;
      }
    }
  }
  *total_terms_out = total;
}

// Emits per-doc sparse vectors (tid, weight) in CSR form. Returns number of
// entries written, or -1 if `cap` was too small (caller retries with a
// bigger buffer).
int64_t dhr_bm25_weights(const int32_t* tokens, const int64_t* offsets,
                         int64_t n_docs, const int64_t* df, int32_t vocab,
                         double avgdl, int64_t collection_docs, double k1,
                         double b, int32_t* out_tids, float* out_weights,
                         int64_t* out_offsets, int64_t cap) {
  std::vector<int32_t> tf(vocab, 0);
  std::vector<int32_t> touched;
  int64_t w = 0;
  out_offsets[0] = 0;
  for (int64_t d = 0; d < n_docs; d++) {
    touched.clear();
    int64_t dl = offsets[d + 1] - offsets[d];
    for (int64_t j = offsets[d]; j < offsets[d + 1]; j++) {
      int32_t t = tokens[j];
      if (t < 0 || t >= vocab) continue;
      if (tf[t] == 0) touched.push_back(t);
      tf[t]++;
    }
    std::sort(touched.begin(), touched.end());
    double norm = 1.0 - b + b * (double)dl / (avgdl > 0 ? avgdl : 1.0);
    for (int32_t t : touched) {
      if (w >= cap) return -1;
      double idf = std::log(
          1.0 + ((double)collection_docs - (double)df[t] + 0.5) /
                    ((double)df[t] + 0.5));
      double f = (double)tf[t];
      out_tids[w] = t;
      out_weights[w] = (float)(idf * f * (k1 + 1.0) / (f + k1 * norm));
      w++;
      tf[t] = 0;
    }
    out_offsets[d + 1] = w;
  }
  return w;
}

// ---------------------------------------------------------------------------
// fold-max densification of CSR sparse vectors
// ---------------------------------------------------------------------------

// values: (n_docs, out_dim) f32 zero-init by caller; indices: (n_docs,
// out_dim) i32 zero-init. Returns total slice-collision count.
int64_t dhr_densify_csr(const int32_t* tids, const float* weights,
                        const int64_t* offsets, int64_t n_docs,
                        int32_t omission, int32_t out_dim, int32_t vocab,
                        float* values, int32_t* indices) {
  int64_t collisions = 0;
  std::vector<uint8_t> occupied(out_dim, 0);
  for (int64_t d = 0; d < n_docs; d++) {
    std::fill(occupied.begin(), occupied.end(), 0);
    float* v = values + d * out_dim;
    int32_t* ix = indices + d * out_dim;
    for (int64_t j = offsets[d]; j < offsets[d + 1]; j++) {
      int32_t t = tids[j];
      if (t < omission || t >= vocab) continue;
      int32_t u = t - omission;
      int32_t slice = u % out_dim;
      int32_t fold = u / out_dim;
      if (occupied[slice]) {
        collisions++;
        // max wins; first (lowest fold) wins ties — tids are ascending per
        // doc in our writers, matching the reshape/argmax semantics.
        if (weights[j] > v[slice]) { v[slice] = weights[j]; ix[slice] = fold; }
      } else {
        occupied[slice] = 1;
        v[slice] = weights[j];
        ix[slice] = fold;
      }
    }
  }
  return collisions;
}

// ---------------------------------------------------------------------------
// k-way top-k merge (faiss ResultHeap role)
// ---------------------------------------------------------------------------

// scores/ids: (n_shards, n_queries, k_in) -> out (n_queries, k_out),
// descending by score, ties by ascending id.
void dhr_merge_topk(const float* scores, const int64_t* ids, int64_t n_shards,
                    int64_t n_queries, int64_t k_in, int64_t k_out,
                    float* out_scores, int64_t* out_ids) {
  std::vector<std::pair<float, int64_t>> pool;
  pool.reserve(n_shards * k_in);
  for (int64_t q = 0; q < n_queries; q++) {
    pool.clear();
    for (int64_t s = 0; s < n_shards; s++) {
      const float* sc = scores + (s * n_queries + q) * k_in;
      const int64_t* id = ids + (s * n_queries + q) * k_in;
      for (int64_t j = 0; j < k_in; j++) pool.push_back({sc[j], id[j]});
    }
    int64_t k = std::min<int64_t>(k_out, (int64_t)pool.size());
    std::partial_sort(
        pool.begin(), pool.begin() + k, pool.end(),
        [](const std::pair<float, int64_t>& a,
           const std::pair<float, int64_t>& b) {
          if (a.first != b.first) return a.first > b.first;
          return a.second < b.second;
        });
    for (int64_t j = 0; j < k_out; j++) {
      if (j < k) {
        out_scores[q * k_out + j] = pool[j].first;
        out_ids[q * k_out + j] = pool[j].second;
      } else {
        out_scores[q * k_out + j] = -INFINITY;
        out_ids[q * k_out + j] = -1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// first-fit-decreasing token-packing planner (encode --pack)
// ---------------------------------------------------------------------------

// The exact algorithm of dhr_tpu_torch.encode.plan_packing (same outputs
// item for item, so the Python/C++ twins are interchangeable): histogram
// buckets per length (FIFO within a length keeps plan order stable in input
// order), an ascending `avail` vector of distinct lengths with items left,
// and per slot a binary search for the longest remaining length that still
// fits.
//
// lengths: (n) i64, pre-clipped by the caller to [1, row_len].
// out_items: (n) i64 — item indices in plan order.
// out_row_offsets: (n + 1) i64 — row r spans out_items[off[r]:off[r+1]];
// every row holds at least one item (the smallest remaining length always
// fits an empty row), so n rows is the worst case. Returns the row count.
int64_t dhr_plan_packing(const int64_t* lengths, int64_t n, int32_t row_len,
                         int32_t max_segments, int64_t* out_items,
                         int64_t* out_row_offsets) {
  std::vector<std::vector<int64_t>> by_len(row_len + 1);
  for (int64_t i = 0; i < n; i++) by_len[lengths[i]].push_back(i);
  std::vector<int64_t> heads(row_len + 1, 0);
  std::vector<int32_t> avail;
  for (int32_t l = 1; l <= row_len; l++)
    if (!by_len[l].empty()) avail.push_back(l);

  int64_t n_rows = 0, pos = 0;
  out_row_offsets[0] = 0;
  while (!avail.empty()) {
    int32_t cap = row_len;
    int32_t in_row = 0;
    while (in_row < max_segments) {
      // rightmost avail length <= cap (bisect_right - 1)
      auto it = std::upper_bound(avail.begin(), avail.end(), cap);
      if (it == avail.begin()) break;
      --it;
      int32_t l = *it;
      auto& q = by_len[l];
      out_items[pos++] = q[heads[l]++];
      if (heads[l] == (int64_t)q.size()) avail.erase(it);
      cap -= l;
      in_row++;
    }
    n_rows++;
    out_row_offsets[n_rows] = pos;
  }
  return n_rows;
}

}  // extern "C"
