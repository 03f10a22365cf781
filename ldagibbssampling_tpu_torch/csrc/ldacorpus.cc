// Host corpus ingest: tokenize + filter + vocabulary build in C++.
//
// The port's copy of the JAX package's native ingest, with the same
// extern "C" surface and semantics.  Reference semantics:
// src/liuyang/nlp/lda/main/Documents.java (SURVEY.md §2.1 #3, §3.1):
// whitespace tokenize (StringTokenizer delimiters " \t\n\r\f"),
// lowercase, Java trim (strip chars <= 0x20), drop stopwords and noise
// words (URL-ish or no ASCII letter), assign vocabulary ids in first-seen
// order, count term frequencies.
//
// The fast path for large corpora, where the pure-Python pipeline
// (corpus/documents.py, the fidelity path) is host-bound.  Byte-oriented:
// lowercasing covers ASCII A-Z only, so corpus/native.py routes non-ASCII
// corpora to the Python pipeline.
//
// Host code, not a kernel: ops/_build.build_host compiles it with $CXX
// (default g++) into _build/ at first use; see corpus/native.py.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_set>
#include <vector>

namespace {

struct LdaCorpus {
  std::vector<int32_t> token_word;
  std::vector<int64_t> doc_ptr;        // [M+1] CSR offsets into token_word
  std::string vocab_buf;               // concatenated terms, first-seen order
  std::vector<int64_t> vocab_offsets;  // [V+1] offsets into vocab_buf
  std::vector<int64_t> term_counts;    // [V]

  std::string_view term(int32_t id) const {
    return std::string_view(vocab_buf).substr(
        static_cast<size_t>(vocab_offsets[id]),
        static_cast<size_t>(vocab_offsets[id + 1] - vocab_offsets[id]));
  }
};

// FNV-1a over the term's bytes.
inline uint64_t hash_term(std::string_view w) {
  uint64_t h = 1469598103934665603ull;
  for (unsigned char ch : w) h = (h ^ ch) * 1099511628211ull;
  return h;
}

// term -> id, open addressing with linear probing over the corpus's own
// vocabulary (the key bytes stay in vocab_buf, found by id): one probe of
// a flat array per token where a node-based map chases pointers.
class VocabIndex {
 public:
  explicit VocabIndex(const LdaCorpus& c) : c_(c) { resize(1 << 16); }

  // The term's id, or -1; `slot` is where it would go.
  int32_t find(std::string_view w, uint64_t h, size_t* slot) const {
    size_t i = h & mask_;
    while (slots_[i].id >= 0) {
      if (slots_[i].hash == h && c_.term(slots_[i].id) == w) return slots_[i].id;
      i = (i + 1) & mask_;
    }
    *slot = i;
    return -1;
  }

  void insert(size_t slot, uint64_t h, int32_t id) {
    slots_[slot] = {h, id};
    if (2 * static_cast<size_t>(++size_) > slots_.size()) resize(2 * slots_.size());
  }

 private:
  struct Slot {
    uint64_t hash;
    int32_t id;  // -1: empty
  };

  void resize(size_t n) {
    std::vector<Slot> old(n, Slot{0, -1});
    old.swap(slots_);
    mask_ = n - 1;
    for (const Slot& s : old) {
      if (s.id < 0) continue;
      size_t i = s.hash & mask_;
      while (slots_[i].id >= 0) i = (i + 1) & mask_;
      slots_[i] = s;
    }
  }

  const LdaCorpus& c_;
  std::vector<Slot> slots_;
  size_t mask_ = 0;
  int32_t size_ = 0;
};

inline bool is_delim(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f';
}

// Java String.trim(): strip leading/trailing chars with code point <= 0x20.
inline std::string_view java_trim(std::string_view s) {
  size_t b = 0, e = s.size();
  while (b < e && static_cast<unsigned char>(s[b]) <= 0x20) ++b;
  while (e > b && static_cast<unsigned char>(s[e - 1]) <= 0x20) --e;
  return s.substr(b, e - b);
}

// Documents.Document.isNoiseWord: URL-ish tokens or no ASCII letter.
inline bool is_noise(std::string_view w) {
  bool has_letter = false;
  for (unsigned char c : w) {
    if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')) {
      has_letter = true;
      break;
    }
  }
  if (!has_letter) return true;
  return w.find("www.") != std::string_view::npos ||
         w.find(".com") != std::string_view::npos ||
         w.find("http:") != std::string_view::npos;
}

}  // namespace

extern "C" {

// text: all documents concatenated; doc_off: [ndocs+1] byte offsets.
// stop / stop_off: the stopword list, same encoding ([nstop+1] offsets).
// Returns an opaque handle (nullptr on invalid arguments).
void* lda_ingest(const char* text, const int64_t* doc_off, int64_t ndocs,
                 const char* stop, const int64_t* stop_off, int64_t nstop) {
  if (!text || !doc_off || ndocs < 0) return nullptr;
  auto* c = new LdaCorpus();
  c->doc_ptr.reserve(ndocs + 1);
  c->doc_ptr.push_back(0);
  c->vocab_offsets.push_back(0);

  std::unordered_set<std::string_view> stopset;
  stopset.reserve(static_cast<size_t>(nstop) * 2);
  for (int64_t i = 0; i < nstop; ++i) {
    stopset.emplace(stop + stop_off[i],
                    static_cast<size_t>(stop_off[i + 1] - stop_off[i]));
  }

  VocabIndex vocab(*c);
  std::string tok;  // reused lowercase buffer

  for (int64_t d = 0; d < ndocs; ++d) {
    const char* p = text + doc_off[d];
    const char* end = text + doc_off[d + 1];
    while (p < end) {
      while (p < end && is_delim(static_cast<unsigned char>(*p))) ++p;
      const char* t0 = p;
      while (p < end && !is_delim(static_cast<unsigned char>(*p))) ++p;
      if (p == t0) continue;
      tok.assign(t0, static_cast<size_t>(p - t0));
      for (char& ch : tok) {
        if (ch >= 'A' && ch <= 'Z') ch = static_cast<char>(ch - 'A' + 'a');
      }
      std::string_view w = java_trim(tok);
      // A term in the vocabulary passed the filters when it was first seen,
      // so only a term not in it is checked against them.
      const uint64_t h = hash_term(w);
      size_t slot = 0;
      int32_t id = vocab.find(w, h, &slot);
      if (id >= 0) {
        ++c->term_counts[static_cast<size_t>(id)];
      } else {
        if (w.empty() || stopset.count(w) || is_noise(w)) continue;
        id = static_cast<int32_t>(c->term_counts.size());
        c->vocab_buf.append(w.data(), w.size());
        c->vocab_offsets.push_back(static_cast<int64_t>(c->vocab_buf.size()));
        c->term_counts.push_back(1);
        vocab.insert(slot, h, id);
      }
      c->token_word.push_back(id);
    }
    c->doc_ptr.push_back(static_cast<int64_t>(c->token_word.size()));
  }
  return c;
}

int64_t lda_num_tokens(void* h) {
  return static_cast<int64_t>(static_cast<LdaCorpus*>(h)->token_word.size());
}
int64_t lda_num_docs(void* h) {
  return static_cast<int64_t>(static_cast<LdaCorpus*>(h)->doc_ptr.size()) - 1;
}
int64_t lda_vocab_size(void* h) {
  return static_cast<int64_t>(static_cast<LdaCorpus*>(h)->term_counts.size());
}
int64_t lda_vocab_bytes(void* h) {
  return static_cast<int64_t>(static_cast<LdaCorpus*>(h)->vocab_buf.size());
}
void lda_copy_tokens(void* h, int32_t* out) {
  auto* c = static_cast<LdaCorpus*>(h);
  std::memcpy(out, c->token_word.data(), c->token_word.size() * sizeof(int32_t));
}
void lda_copy_doc_ptr(void* h, int64_t* out) {
  auto* c = static_cast<LdaCorpus*>(h);
  std::memcpy(out, c->doc_ptr.data(), c->doc_ptr.size() * sizeof(int64_t));
}
void lda_copy_vocab(void* h, char* buf, int64_t* offsets) {
  auto* c = static_cast<LdaCorpus*>(h);
  std::memcpy(buf, c->vocab_buf.data(), c->vocab_buf.size());
  std::memcpy(offsets, c->vocab_offsets.data(),
              c->vocab_offsets.size() * sizeof(int64_t));
}
void lda_copy_term_counts(void* h, int64_t* out) {
  auto* c = static_cast<LdaCorpus*>(h);
  std::memcpy(out, c->term_counts.data(),
              c->term_counts.size() * sizeof(int64_t));
}
void lda_destroy(void* h) { delete static_cast<LdaCorpus*>(h); }

}  // extern "C"
