// The port's host-side sampling and prep, the counterparts of the rest of
// the JAX package's native/recsys_native.cc:
//
//   * sample_negatives: uniform draws from [lo, hi) outside a per-query
//     exclusion list;
//   * build_seq_leave_last2: the SASRec leave-last-2 dataset, train rows
//     exploded by prefix or one row a user over every position;
//   * shuffle_indices: a seeded Fisher-Yates permutation;
//   * fused_prep / fused_prep_group: the host prep of the fused embedding
//     update (kernels #4 and #5): a batch's ids of one table sorted by row,
//     bucketed by table block into chunks of `ch` slots at the static chunk
//     count nc_max = n / ch + nb.
//
// The random draws are the JAX library's byte for byte: one PCG32 stream a
// query or a user, seeded seed + i * 0x9E3779B97F4A7C15, increment
// 0xDA3E39CB94B95BDB | 1, bounded by rejection.  Where the JAX library
// loops forever (an exclusion list that covers the whole range), these
// return -1 instead.
//
// fused_prep gives output bit-equal to the JAX fused_prep with one shard,
// but not by its algorithm: the JAX counting sort allocates and scans a
// (vp + 1) int64 array a call, 8 MB at 2^20 rows for a batch's 4096 ids.
// Here a radix sort puts the ids in stable order by row in two passes of
// 2048 buckets (tables below 2^22 rows): O(n + nb + nc_max * ch) a call.
// fused_prep_group reads the ids of a group's columns straight from the
// (B, F) batch and writes, where the JAX prep writes a slot's occurrence,
// its row of the (B * F, D) tap cotangent.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, with criteo_parse.cc into one
// library (recsys_tpu_torch/data/native.py does it at first use).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

struct Pcg32 {
  uint64_t state, inc;
};

inline uint32_t pcg32_next(Pcg32* r) {
  uint64_t old = r->state;
  r->state = old * 6364136223846793005ULL + r->inc;
  uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
  uint32_t rot = (uint32_t)(old >> 59u);
  return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
}

inline uint32_t pcg32_below(Pcg32* r, uint32_t bound) {
  uint32_t threshold = (uint32_t)(-bound) % bound;
  for (;;) {
    uint32_t x = pcg32_next(r);
    if (x >= threshold) return x % bound;
  }
}

inline Pcg32 stream_of(uint64_t seed, uint64_t i) {
  return Pcg32{seed + i * 0x9E3779B97F4A7C15ULL, 0xDA3E39CB94B95BDBULL | 1};
}

// How many values of [lo, hi) the set holds.
int64_t covered(const std::unordered_set<int32_t>& excl, int64_t lo, int64_t hi) {
  int64_t n = 0;
  for (int32_t x : excl) n += (x >= lo && x < hi);
  return n;
}

void pad_write(const int32_t* seq, int64_t len, int32_t maxlen, int32_t* dst) {
  int64_t take = len < maxlen ? len : maxlen;
  int64_t padn = maxlen - take;
  for (int64_t i = 0; i < padn; ++i) dst[i] = 0;
  memcpy(dst + padn, seq + (len - take), (size_t)take * sizeof(int32_t));
}

// Work space of the prep, kept by each calling thread from one call to the
// next: a fresh vector a call paid for its pages (mmap, zeroing, faults),
// which cost more than the sort itself at 16384 ids.
struct PrepScratch {
  std::vector<int32_t> rows, at;
  std::vector<uint64_t> keys, tmp;
  std::vector<int64_t> start;
};
thread_local PrepScratch scratch;

template <class T>
T* room(std::vector<T>& v, int64_t n) {
  if ((int64_t)v.size() < n) v.resize((size_t)n);
  return v.data();
}

// The prep of the n occurrences whose table rows are rows[0 .. n): a row
// outside [0, vp) returns -1 before anything is written, shards that do
// not divide vp -2.  With shards > 1 the block fences align to the row
// shards of a model axis: shard s owns rows [s * vs, (s + 1) * vs), vs =
// vp / shards, in nb_s = ceil(vs / block) blocks, nb = shards * nb_s in
// all, so that shard s's update reads cptr[s * nb_s .. (s + 1) * nb_s].  A slot's entry
// of idx is its occurrence i, or src[i] where src is given (and a sentinel
// slot's that of occurrence 0).  The occurrences are put in stable order
// by row with a least-significant-digit radix sort of (row << 32 | i)
// keys, 11 bits of the row a pass (2 passes below 2^22 rows), and the
// block fences found by walking the sorted rows: no per-id division.
int prep(const int32_t* rows, int64_t n, const int32_t* src, int32_t vp, int32_t block,
         int32_t ch, int32_t shards, int32_t* ids2d, int32_t* idx, int32_t* cptr) {
  if (shards < 1 || vp % shards) return -2;
  const int32_t vs = vp / shards, nb_s = (vs + block - 1) / block, nb = shards * nb_s;
  const int64_t nc_max = n / ch + nb;
  constexpr int kBits = 11, kBuckets = 1 << kBits;
  uint64_t* keys = room(scratch.keys, n);
  uint64_t* tmp = room(scratch.tmp, n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t r = rows[i];
    if (r < 0 || r >= vp) return -1;
    keys[i] = ((uint64_t)(uint32_t)r << 32) | (uint64_t)i;
  }
  int row_bits = 1;
  while (row_bits < 31 && ((int64_t)1 << row_bits) < vp) ++row_bits;
  int64_t count[kBuckets];
  for (int shift = 32; shift < 32 + row_bits; shift += kBits) {
    std::fill(count, count + kBuckets, 0);
    for (int64_t i = 0; i < n; ++i) count[(keys[i] >> shift) & (kBuckets - 1)]++;
    int64_t at = 0;
    for (int64_t& c : count) {
      int64_t here = c;
      c = at;
      at += here;
    }
    for (int64_t i = 0; i < n; ++i) tmp[count[(keys[i] >> shift) & (kBuckets - 1)]++] = keys[i];
    std::swap(keys, tmp);
  }
  // block k's sorted occurrences are keys[start[k] .. start[k + 1])
  int64_t* start = room(scratch.start, (int64_t)nb + 1);
  start[nb] = n;
  int64_t j = 0;
  for (int32_t k = 0; k < nb; ++k) {
    start[k] = j;
    // shard s's blocks fence its rows [s * vs, (s + 1) * vs) every `block`
    const int32_t s = k / nb_s;
    const int64_t hi = std::min((int64_t)s * vs + (int64_t)(k - s * nb_s + 1) * block,
                                (int64_t)(s + 1) * vs);
    while (j < n && (int64_t)(keys[j] >> 32) < hi) ++j;
  }
  cptr[0] = 0;
  for (int32_t k = 0; k < nb; ++k)
    cptr[k + 1] = cptr[k] + (int32_t)((start[k + 1] - start[k] + ch - 1) / ch);
  cptr[nb] = (int32_t)nc_max;  // the static padding chunks go to the last block
  const int32_t sentinel = nb * block;
  std::fill(ids2d, ids2d + nc_max * ch, sentinel);
  // a sentinel slot holds occurrence 0, as the JAX prep's idx does
  std::fill(idx, idx + nc_max * ch, src && n ? src[0] : 0);
  for (int32_t k = 0; k < nb; ++k) {
    int64_t dst = (int64_t)cptr[k] * ch;
    for (int64_t q = start[k]; q < start[k + 1]; ++q, ++dst) {
      const uint64_t key = keys[q];
      const int32_t i = (int32_t)(key & 0xFFFFFFFFu);
      ids2d[dst] = (int32_t)(key >> 32);
      idx[dst] = src ? src[i] : i;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// For each of n_queries, n_neg uniform draws from [lo, hi) that are not in
// the query's exclusion list excl_ids[excl_off[i] .. excl_off[i + 1]);
// out is (n_queries, n_neg).  Returns 0, or -1 when a list covers [lo, hi).
int sample_negatives(int64_t n_queries, int32_t n_neg, int32_t lo, int32_t hi,
                     const int32_t* excl_ids, const int64_t* excl_off, uint64_t seed,
                     int32_t* out) {
  uint32_t range = (uint32_t)(hi - lo);
  for (int64_t i = 0; i < n_queries; ++i) {
    Pcg32 rng = stream_of(seed, (uint64_t)i);
    std::unordered_set<int32_t> excl(excl_ids + excl_off[i], excl_ids + excl_off[i + 1]);
    if (n_neg > 0 && covered(excl, lo, hi) >= (int64_t)range) return -1;
    for (int32_t j = 0; j < n_neg; ++j) {
      int32_t cand;
      do {
        cand = lo + (int32_t)pcg32_below(&rng, range);
      } while (excl.count(cand));
      out[i * n_neg + j] = cand;
    }
  }
  return 0;
}

// The SASRec leave-last-2 dataset.  items: 1-based item ids (0 = pad),
// each user's in time order, user u's at items[user_off[u] ..
// user_off[u + 1]).  A user of fewer than 3 items is skipped.  Training
// rows: with all_positions = 0, one a position t in [1, len - 3] (hist the
// front-padded seq[:t], pos seq[t], one negative); with all_positions = 1,
// one a user of at least 4 items (hist pad(seq[:-3]), pos pad(seq[1:-2]),
// a negative a real position, 0 at a pad).  Validation: hist
// pad(seq[:-2]), pos seq[-2]; test: hist pad(seq[:-1]), pos seq[-1];
// test_neg negatives each.  Every negative is drawn from [1, num_items)
// outside the user's items.  Writes {n_train, n_eval} to out_counts;
// returns 0, or -1 when a user's items leave no negative to draw.
int build_seq_leave_last2(const int32_t* items, const int64_t* user_off, int64_t n_users,
                          int32_t maxlen, int32_t num_items, int32_t test_neg, uint64_t seed,
                          int all_positions, int32_t* tr_hist, int32_t* tr_pos,
                          int32_t* tr_neg, int32_t* va_hist, int32_t* va_pos,
                          int32_t* va_neg, int32_t* te_hist, int32_t* te_pos,
                          int32_t* te_neg, int64_t* out_counts) {
  int64_t n_train = 0, n_eval = 0;
  uint32_t range = (uint32_t)(num_items - 1);
  for (int64_t u = 0; u < n_users; ++u) {
    const int32_t* seq = items + user_off[u];
    int64_t len = user_off[u + 1] - user_off[u];
    if (len < 3) continue;
    std::unordered_set<int32_t> excl(seq, seq + len);
    if (covered(excl, 1, num_items) >= (int64_t)range) return -1;
    Pcg32 rng = stream_of(seed, (uint64_t)u);
    auto draw = [&]() {
      int32_t cand;
      do {
        cand = 1 + (int32_t)pcg32_below(&rng, range);
      } while (excl.count(cand));
      return cand;
    };
    if (all_positions) {
      int64_t tlen = len - 2;  // the training sequence seq[:-2]
      if (tlen >= 2) {
        pad_write(seq, tlen - 1, maxlen, tr_hist + n_train * maxlen);
        pad_write(seq + 1, tlen - 1, maxlen, tr_pos + n_train * maxlen);
        int32_t* neg = tr_neg + n_train * maxlen;
        const int32_t* tgt = tr_pos + n_train * maxlen;
        for (int32_t j = 0; j < maxlen; ++j) neg[j] = tgt[j] > 0 ? draw() : 0;
        ++n_train;
      }
    } else {
      for (int64_t t = 1; t <= len - 3; ++t) {
        pad_write(seq, t, maxlen, tr_hist + n_train * maxlen);
        tr_pos[n_train] = seq[t];
        tr_neg[n_train] = draw();
        ++n_train;
      }
    }
    pad_write(seq, len - 2, maxlen, va_hist + n_eval * maxlen);
    va_pos[n_eval] = seq[len - 2];
    for (int32_t j = 0; j < test_neg; ++j) va_neg[n_eval * test_neg + j] = draw();
    pad_write(seq, len - 1, maxlen, te_hist + n_eval * maxlen);
    te_pos[n_eval] = seq[len - 1];
    for (int32_t j = 0; j < test_neg; ++j) te_neg[n_eval * test_neg + j] = draw();
    ++n_eval;
  }
  out_counts[0] = n_train;
  out_counts[1] = n_eval;
  return 0;
}

// A permutation of [0, n): Fisher-Yates from the last position down.
void shuffle_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  Pcg32 rng{seed, 0xDA3E39CB94B95BDBULL | 1};
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)pcg32_below(&rng, (uint32_t)(i + 1));
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// The fused update's prep of one table of vp rows from n ids: ids2d
// (nc_max, ch) the ids of block k in chunks [cptr[k], cptr[k + 1]) in
// stable order by row, the rest the sentinel nb * block; idx (nc_max * ch)
// each slot's position in ids (0 at a sentinel); cptr (nb + 1) with
// cptr[nb] = nc_max; the fences of `shards` row shards (see prep).
// Returns 0, -1 for an id outside [0, vp), -2 for shards not dividing vp.
int fused_prep(const int32_t* ids, int64_t n, int32_t vp, int32_t block, int32_t ch,
               int32_t shards, int32_t* ids2d, int32_t* idx, int32_t* cptr) {
  return prep(ids, n, nullptr, vp, block, ch, shards, ids2d, idx, cptr);
}

// fused_prep over one table group of a (b, f) batch: its occurrences are
// column cols[j]'s ids plus offs[j], column after column (occurrence j * b
// + r is row r of column cols[j]), and a slot's src is the occurrence's
// row r * f + cols[j] of the (b * f, D) tap cotangent.
int fused_prep_group(const int32_t* sparse, int64_t b, int32_t f, const int32_t* cols,
                     const int32_t* offs, int32_t ncols, int32_t vp, int32_t block, int32_t ch,
                     int32_t shards, int32_t* ids2d, int32_t* src, int32_t* cptr) {
  int32_t* rows = room(scratch.rows, b * ncols);
  int32_t* at = room(scratch.at, b * ncols);
  for (int32_t j = 0; j < ncols; ++j)
    for (int64_t r = 0; r < b; ++r) {
      at[j * b + r] = (int32_t)(r * f + cols[j]);
      rows[j * b + r] = sparse[r * f + cols[j]] + offs[j];
    }
  return prep(rows, b * ncols, at, vp, block, ch, shards, ids2d, src, cptr);
}

}  // extern "C"
