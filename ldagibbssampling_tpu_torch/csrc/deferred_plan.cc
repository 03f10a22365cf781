// The deferred tier's token layout (ops/count_kernel.plan_deferred) in host
// C++: the same plan as the reference's numpy planner
// (ldagibbssampling_tpu/ops/count_kernel.py:85), field by field, in time
// linear in tokens + blocks x stripes.
//
// Pass 1 fills blocks greedily in token order, exactly the reference's rule:
// a block's candidate is the next block_size tokens; while its runs, one per
// vocabulary stripe of v_loc word ids, padded to 8 slots each, take more
// than block_size slots, the candidate shrinks by the overshoot.  The stripe
// histogram is kept incrementally (a shrink takes the cut tokens out again),
// so each attempt costs the tokens it adds or removes.  Then, per block (on
// threads; a block writes only its own slots, so the result does not depend
// on their number), a stable two-digit counting sort by word (low digit
// word % v_loc, then the stripe) is np.argsort(kind="stable")'s order, and
// each stripe's run lands at its slot with its 8-slot pads and the block's
// tail pads.  Pass 2 writes the stripe-major rebuild stream, one stripe per
// task.  Every index is 64-bit.
//
// Host code, not a kernel: ops/_build.build_host compiles it with $CXX
// (default g++) into _build/ at first use; ops/count_kernel.py binds it
// with ctypes and passes numpy arrays it allocated.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kAlign = 8;  // (block, stripe) runs start and end on 8-slot edges

inline int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

// Error codes of lda_plan_create / lda_plan_fill (ops/count_kernel.py maps
// them to the reference's exceptions).
enum : int32_t {
  kOk = 0,
  kBlockTooSmall = 1,  // "block_size too small for stripe alignment"
  kNegativeWord = 2,
  kWordPastVocab = 3,  // a word id >= v_pad
  kNoMemory = 4,
};

struct Run {
  int64_t stripe;
  int64_t real;   // real tokens
  int64_t start;  // first slot in the sweep layout
};

struct Plan {
  int64_t t_real = 0, v_loc = 0, v_pad = 0, num_stripes = 0;
  int64_t block_size = 0, tile = 0;
  std::vector<int64_t> block_start, block_len;  // real tokens per block
  std::vector<int64_t> run_off;                 // [nb + 1] into runs
  std::vector<Run> runs;                        // block-major, stripes ascending
  std::vector<int64_t> stripe_start;            // [stripes + 1] in the rebuild stream
  int64_t max_word_freq = 0;

  int64_t num_blocks() const { return static_cast<int64_t>(block_len.size()); }
  int64_t rebuild_len() const { return stripe_start.back(); }
};

// fn(i) for i in [0, n) on up to `threads` threads, items handed out in
// order; returns false if any call threw.
template <class Fn>
bool parallel_for(int64_t n, int threads, Fn fn) {
  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  auto work = [&] {
    try {
      for (int64_t i; !failed && (i = next.fetch_add(1)) < n;) fn(i);
    } catch (...) {
      failed = true;
    }
  };
  int64_t t = std::max<int64_t>(1, std::min<int64_t>(threads, n));
  std::vector<std::thread> pool;
  try {
    for (int64_t k = 1; k < t; ++k) pool.emplace_back(work);
  } catch (...) {
    failed = true;
  }
  work();
  for (auto& th : pool) th.join();
  return !failed;
}

// Validation, the word frequencies and pass 1: the blocks and their runs.
int32_t build(Plan& p, const int32_t* word) {
  const int64_t t = p.t_real;
  int64_t max_word = -1;
  for (int64_t i = 0; i < t; ++i) {
    if (word[i] < 0) return kNegativeWord;
    if (word[i] >= p.v_pad) return kWordPastVocab;
    max_word = std::max<int64_t>(max_word, word[i]);
  }
  {
    std::vector<int64_t> freq(static_cast<size_t>(max_word + 1), 0);
    for (int64_t i = 0; i < t; ++i) ++freq[word[i]];
    for (int64_t f : freq) p.max_word_freq = std::max(p.max_word_freq, f);
  }

  const int64_t bs = p.block_size, v_loc = p.v_loc;
  std::vector<int64_t> count(static_cast<size_t>(p.num_stripes), 0);
  std::vector<int64_t> touched;  // stripes counted in the current candidate
  std::vector<int64_t> stripe_slots(static_cast<size_t>(p.num_stripes), 0);
  p.run_off.push_back(0);
  for (int64_t pos = 0; pos < t;) {
    int64_t n = std::min(bs, t - pos), padded = 0;
    for (int64_t i = pos; i < pos + n; ++i) {
      int64_t& c = count[word[i] / v_loc];
      if (c == 0) touched.push_back(word[i] / v_loc);
      if (c % kAlign == 0) padded += kAlign;
      ++c;
    }
    while (padded > bs) {
      int64_t n_new = n - (padded - bs);
      if (n_new <= 0) return kBlockTooSmall;
      for (int64_t i = pos + n_new; i < pos + n; ++i) {
        int64_t& c = count[word[i] / v_loc];
        if (--c % kAlign == 0) padded -= kAlign;
      }
      n = n_new;
    }
    std::sort(touched.begin(), touched.end());
    int64_t cursor = p.num_blocks() * bs;
    for (int64_t s : touched) {
      int64_t real = count[s];
      count[s] = 0;
      if (real == 0) continue;  // every token of it was cut
      int64_t slots = round_up(real, kAlign);
      p.runs.push_back({s, real, cursor});
      stripe_slots[s] += slots;
      cursor += slots;
    }
    touched.clear();
    p.block_start.push_back(pos);
    p.block_len.push_back(n);
    p.run_off.push_back(static_cast<int64_t>(p.runs.size()));
    pos += n;
  }
  if (p.block_len.empty()) {  // no tokens: one block of padding
    p.block_start.push_back(0);
    p.block_len.push_back(0);
    p.run_off.push_back(0);
  }
  // every stripe padded to whole tiles, at least one
  p.stripe_start.assign(static_cast<size_t>(p.num_stripes + 1), 0);
  for (int64_t s = 0; s < p.num_stripes; ++s)
    p.stripe_start[s + 1] = p.stripe_start[s] +
        std::max(round_up(stripe_slots[s], p.tile), p.tile);
  return kOk;
}

// One block of the sweep layout: word-sorted runs, their pads, the tail.
void fill_block(const Plan& p, int64_t b, const int32_t* word,
                const int32_t* doc, int32_t* out_word, int32_t* out_doc,
                int32_t* out_mask, int64_t* out_perm,
                std::vector<int64_t>& low_off, std::vector<int64_t>& stripe_off,
                std::vector<int64_t>& by_low) {
  const int64_t bs = p.block_size, v_loc = p.v_loc;
  const int64_t base = b * bs, start = p.block_start[b], n = p.block_len[b];
  int32_t* ow = out_word + base;
  int32_t* od = out_doc + base;
  int32_t* om = out_mask + base;
  int64_t* op = out_perm + base;
  std::fill(om, om + bs, 0);
  std::fill(op, op + bs, -1);
  if (n == 0) {
    std::fill(ow, ow + bs, 0);
    std::fill(od, od + bs, 0);
    return;
  }
  const int32_t* w = word + start;
  // digit 1: word % v_loc, stable
  std::fill(low_off.begin(), low_off.end(), 0);
  for (int64_t i = 0; i < n; ++i) ++low_off[w[i] % v_loc + 1];
  for (int64_t d = 0; d < v_loc; ++d) low_off[d + 1] += low_off[d];
  for (int64_t i = 0; i < n; ++i) by_low[low_off[w[i] % v_loc]++] = i;
  // digit 2: the stripe, stable, straight into the runs' slots
  const Run* runs = p.runs.data() + p.run_off[b];
  const int64_t nr = p.run_off[b + 1] - p.run_off[b];
  for (int64_t r = 0; r < nr; ++r) stripe_off[runs[r].stripe] = runs[r].start - base;
  for (int64_t j = 0; j < n; ++j) {
    int64_t i = by_low[j];
    int64_t slot = stripe_off[w[i] / v_loc]++;
    ow[slot] = w[i];
    od[slot] = doc[start + i];
    om[slot] = 1;
    op[slot] = start + i;
  }
  // alignment pads copy their run's last word and doc
  int64_t cursor = 0;
  for (int64_t r = 0; r < nr; ++r) {
    int64_t lo = runs[r].start - base, last = lo + runs[r].real - 1;
    cursor = lo + round_up(runs[r].real, kAlign);
    std::fill(ow + last + 1, ow + cursor, ow[last]);
    std::fill(od + last + 1, od + cursor, od[last]);
  }
  // block-tail pads keep the last word so the block stays sorted
  std::fill(ow + cursor, ow + bs, ow[cursor - 1]);
  std::fill(od + cursor, od + bs, od[cursor - 1]);
}

}  // namespace

extern "C" {

// Pass 1 over word[0, t): a plan handle, or null with *err set.
void* lda_plan_create(const int32_t* word, int64_t t, int64_t v_loc,
                      int64_t v_pad, int64_t block_size, int64_t tile,
                      int32_t* err) {
  Plan* p = nullptr;
  try {
    p = new Plan;
    p->t_real = t;
    p->v_loc = v_loc;
    p->v_pad = v_pad;
    p->num_stripes = v_pad / v_loc;
    p->block_size = block_size;
    p->tile = tile;
    *err = build(*p, word);
  } catch (const std::bad_alloc&) {
    *err = kNoMemory;
  }
  if (*err != kOk) {
    delete p;
    return nullptr;
  }
  return p;
}

int64_t lda_plan_num_blocks(void* h) {
  return static_cast<Plan*>(h)->num_blocks();
}
int64_t lda_plan_rebuild_len(void* h) {
  return static_cast<Plan*>(h)->rebuild_len();
}
int64_t lda_plan_max_word_freq(void* h) {
  return static_cast<Plan*>(h)->max_word_freq;
}

// The sweep layout ([num_blocks * block_size] each) and the rebuild stream
// (row_gather_idx [rebuild_len / 8], w_local [rebuild_len], tile_stripe
// [rebuild_len / tile]), every element written; 0 or kNoMemory.
int32_t lda_plan_fill(void* h, const int32_t* word, const int32_t* doc,
                      int32_t* out_word, int32_t* out_doc, int32_t* out_mask,
                      int64_t* out_perm, int32_t* row_gather_idx,
                      int32_t* w_local, int32_t* tile_stripe, int32_t threads) {
  const Plan& p = *static_cast<Plan*>(h);
  const int64_t nb = p.num_blocks();
  // blocks, each worker taking the next one, with scratch of its own
  const int64_t workers = std::max<int64_t>(1, std::min<int64_t>(threads, nb));
  std::atomic<int64_t> next{0};
  bool ok = parallel_for(workers, static_cast<int>(workers), [&](int64_t) {
    std::vector<int64_t> low_off(static_cast<size_t>(p.v_loc + 1));
    std::vector<int64_t> stripe_off(static_cast<size_t>(p.num_stripes));
    std::vector<int64_t> by_low(static_cast<size_t>(p.block_size));
    for (int64_t b; (b = next.fetch_add(1)) < nb;)
      fill_block(p, b, word, doc, out_word, out_doc, out_mask, out_perm,
                 low_off, stripe_off, by_low);
  });
  if (!ok) return kNoMemory;

  // the runs of each stripe in block order
  std::vector<int64_t> stripe_runs_off, stripe_runs;
  try {
    stripe_runs_off.assign(static_cast<size_t>(p.num_stripes + 1), 0);
    for (const Run& r : p.runs) ++stripe_runs_off[r.stripe + 1];
    for (int64_t s = 0; s < p.num_stripes; ++s)
      stripe_runs_off[s + 1] += stripe_runs_off[s];
    stripe_runs.resize(p.runs.size());
    std::vector<int64_t> at(stripe_runs_off.begin(), stripe_runs_off.end() - 1);
    for (size_t r = 0; r < p.runs.size(); ++r)
      stripe_runs[at[p.runs[r].stripe]++] = static_cast<int64_t>(r);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  // pass 2: per stripe, its runs' rows of z.reshape(-1, 8) and their
  // stripe-relative words; padding rows 0, padding words -1
  ok = parallel_for(p.num_stripes, threads, [&](int64_t s) {
    int64_t out = p.stripe_start[s];
    const int64_t end = p.stripe_start[s + 1];
    const int64_t word0 = s * p.v_loc;
    for (int64_t k = stripe_runs_off[s]; k < stripe_runs_off[s + 1]; ++k) {
      const Run& r = p.runs[stripe_runs[k]];
      const int64_t slots = round_up(r.real, kAlign);
      for (int64_t j = 0; j < slots / kAlign; ++j)
        row_gather_idx[out / kAlign + j] =
            static_cast<int32_t>(r.start / kAlign + j);
      for (int64_t j = 0; j < r.real; ++j)
        w_local[out + j] = static_cast<int32_t>(out_word[r.start + j] - word0);
      std::fill(w_local + out + r.real, w_local + out + slots, -1);
      out += slots;
    }
    std::fill(row_gather_idx + out / kAlign, row_gather_idx + end / kAlign, 0);
    std::fill(w_local + out, w_local + end, -1);
    std::fill(tile_stripe + p.stripe_start[s] / p.tile, tile_stripe + end / p.tile,
              static_cast<int32_t>(s));
  });
  return ok ? kOk : kNoMemory;
}

void lda_plan_destroy(void* h) { delete static_cast<Plan*>(h); }

}  // extern "C"
