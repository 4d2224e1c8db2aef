// gdr_native — the port's host C++ helpers, a copy of native/gdr_native.cpp.
//
// Host hot paths of index build and serving, none of which touch the GPU:
//
//   * trie construction/packing from millions of CID digit paths
//     (gdr_tpu_torch/ops/trie.py::build_trie, index build + expansion),
//   * batch hash tokenization (FNV-1a, bit-identical to
//     gdr_tpu_torch.data.tokenize.HashTokenizer.encode for ASCII text),
//   * TSV corpus scanning.
//
// Exposed as a plain C ABI consumed via ctypes (gdr_tpu_torch/native.py),
// which builds it with the host C++ compiler at first use.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Trie builder
//
// Input: n_docs rows of digit paths, each `lengths[i]` digits in
// paths[i*max_depth .. ].  Nodes are numbered in BFS order (parents before
// children) to keep bottom-up passes a single reversed loop, exactly like
// the Python builder (gdr_tpu_torch/ops/trie.py).
//
// Returns 0 on success, -1 if node capacity exceeded, -2 on bad digit.
// ---------------------------------------------------------------------------

int gdr_build_trie(const int32_t* paths, const int32_t* lengths,
                   int64_t n_docs, int32_t max_depth, int32_t kary,
                   int64_t max_nodes,
                   int32_t* out_children,      // [max_nodes, kary], -1 init by callee
                   uint8_t* out_eos,           // [max_nodes]
                   int32_t* out_depth,         // [max_nodes]
                   int32_t* out_doc_start,     // [max_nodes]
                   int32_t* out_doc_count,     // [max_nodes]
                   int32_t* out_doc_indices,   // [n_docs]
                   int64_t* out_num_nodes) {
  // temporary child maps; BFS numbering achieved by inserting level-by-level
  std::vector<std::vector<int32_t>> child(1, std::vector<int32_t>(kary, -1));
  std::vector<int32_t> depth_v(1, 0);

  int32_t deepest = 0;
  for (int64_t i = 0; i < n_docs; ++i)
    if (lengths[i] > deepest) deepest = lengths[i];

  for (int32_t level = 0; level < deepest; ++level) {
    for (int64_t i = 0; i < n_docs; ++i) {
      if (level >= lengths[i]) continue;
      const int32_t* p = paths + i * max_depth;
      int32_t cur = 0;
      for (int32_t d = 0; d < level; ++d) cur = child[cur][p[d]];
      int32_t digit = p[level];
      if (digit < 0 || digit >= kary) return -2;
      if (child[cur][digit] < 0) {
        if ((int64_t)child.size() >= max_nodes) return -1;
        child[cur][digit] = (int32_t)child.size();
        child.emplace_back(kary, -1);
        depth_v.push_back(level + 1);
      }
    }
  }

  const int64_t n = (int64_t)child.size();
  *out_num_nodes = n;

  // docs attach at their terminal node; group by node preserving doc order
  std::vector<int32_t> terminal(n_docs);
  std::vector<int32_t> count(n, 0);
  for (int64_t i = 0; i < n_docs; ++i) {
    const int32_t* p = paths + i * max_depth;
    int32_t cur = 0;
    for (int32_t d = 0; d < lengths[i]; ++d) cur = child[cur][p[d]];
    terminal[i] = cur;
    count[cur]++;
  }
  std::vector<int32_t> start(n, 0);
  int32_t acc = 0;
  for (int64_t v = 0; v < n; ++v) { start[v] = acc; acc += count[v]; }
  std::vector<int32_t> cursor(start);
  for (int64_t i = 0; i < n_docs; ++i)
    out_doc_indices[cursor[terminal[i]]++] = (int32_t)i;

  for (int64_t v = 0; v < n; ++v) {
    std::memcpy(out_children + v * kary, child[v].data(),
                sizeof(int32_t) * kary);
    out_eos[v] = count[v] > 0 ? 1 : 0;
    out_depth[v] = depth_v[v];
    out_doc_start[v] = start[v];
    out_doc_count[v] = count[v];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// FNV-1a hash tokenizer (batch).
//
// Tokenization rule mirrors the Python regex `\w+|[^\w\s]` for ASCII:
// runs of [A-Za-z0-9_] (plus any byte >= 0x80) form words; other printable
// bytes are single-character tokens.  token id = 2 + fnv1a(word) % (V - 2).
// ---------------------------------------------------------------------------

static inline uint32_t fnv1a(const char* s, size_t len) {
  uint32_t h = 0x811C9DC5u;
  for (size_t i = 0; i < len; ++i) {
    h ^= (uint8_t)s[i];
    h *= 0x01000193u;
  }
  return h;
}

static inline bool is_word_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || c >= 0x80;
}

// texts: concatenated UTF-8 buffer; offsets: [n_texts+1] byte offsets.
void gdr_hash_tokenize_batch(const char* buf, const int64_t* offsets,
                             int64_t n_texts, int32_t max_length,
                             int32_t vocab_size, int32_t lower,
                             int32_t* out_ids /* [n_texts, max_length] */) {
  const uint32_t mod = (uint32_t)(vocab_size - 2);
  std::string word;
  for (int64_t t = 0; t < n_texts; ++t) {
    const char* s = buf + offsets[t];
    const int64_t len = offsets[t + 1] - offsets[t];
    int32_t* row = out_ids + t * max_length;
    std::memset(row, 0, sizeof(int32_t) * max_length);
    int32_t nt = 0;
    int64_t i = 0;
    word.clear();
    while (i < len && nt < max_length) {
      unsigned char c = (unsigned char)s[i];
      if (lower && c >= 'A' && c <= 'Z') c = (unsigned char)(c + 32);
      if (is_word_byte(c)) {
        word.push_back((char)c);
        ++i;
        if (i < len) {
          unsigned char nc = (unsigned char)s[i];
          if (lower && nc >= 'A' && nc <= 'Z') nc = (unsigned char)(nc + 32);
          if (is_word_byte(nc)) continue;
        }
        row[nt++] = 2 + (int32_t)(fnv1a(word.data(), word.size()) % mod);
        word.clear();
      } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                 c == '\f' || c == '\v') {
        ++i;
      } else {  // single-char punctuation token
        char pc = (char)c;
        row[nt++] = 2 + (int32_t)(fnv1a(&pc, 1) % mod);
        ++i;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// TSV scanning: count rows and locate field boundaries for a 2-column file.
// Returns number of rows; fills line_offsets (byte offset of each line start,
// capacity must be >= max_rows+1; last entry = buffer length).
// ---------------------------------------------------------------------------

int64_t gdr_scan_lines(const char* buf, int64_t len, int64_t max_rows,
                       int64_t* line_offsets) {
  int64_t rows = 0;
  int64_t pos = 0;
  while (pos < len && rows < max_rows) {
    line_offsets[rows++] = pos;
    const char* nl = (const char*)memchr(buf + pos, '\n', len - pos);
    if (!nl) { pos = len; break; }
    pos = (nl - buf) + 1;
  }
  line_offsets[rows] = (pos < len) ? pos : len;
  return rows;
}

}  // extern "C"
