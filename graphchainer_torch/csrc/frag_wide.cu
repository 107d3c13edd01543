// Wide-band, full-start banded Myers DP (optimal mode and seedless DP).
//
// Replaces: graphchainer_tpu/ops/frag_align.py::align_fragments with
// full_start (optimal mode's whole-component bands, models/optimal.py,
// and seedless DP's tiles, align/seedless.py), which JAX runs as one XLA
// loop and never sends to its Pallas kernel.  Computes exactly
// graphchainer_torch/ops/frag_align.py::align_fragments_plain (no
// carry_in, no X cells, no state out): per fragment, per 32-row slice, per
// topological level, every band slot of the level merges its candidate
// words (seed injection at slice 0: at every active slot with full_start;
// the vertical carry at later slices; its in-band predecessors advanced
// one column) by exact elementwise min of their row scores, advances its
// remaining columns, and with full_start merges a free-start word into
// every column.  Outputs: best_in (F, B, S) int8 or int16, each slot's
// best end score and column (F, B), the best over slots (F,).
//
// Inputs: band_nodes int32 (F, B), band_in int16 (F, B, max_in),
// band_level int32 (F, B), seed_shift int32 (F,) (slot 0), req uint32
// bits (F, S, 4), rows int32 (F,), seed_base int32 (F,) or null, the
// resident node table node_eq (N2, 4) / node_len (N2,); scratch int4
// (F, T, B) for end words, T = max(2, min(S, 128)).
//
// What bounds it on the H100: neither bytes nor operations.  Optimal mode
// runs F = 1 fragment (a whole component, B up to 4096 slots) against
// S = 128 slices of a 3 kbp read: ~10 MB moved, ~0.2 G integer operations,
// tens of microseconds either way.  What is left is the dependent chain: a
// slot's columns are a serial Myers recurrence (~10 dependent
// instructions a column, up to 31 columns), a slice's slots are a chain of
// ~3,000 topological levels, and a slot's slice s needs its slice s - 1.
//
// Design, against that chain:
// - One block of 128 threads per fragment.  A fragment whose in-edges all
//   come from a lower level (every band the callers build from a DAG) runs
//   the slices as a wavefront: thread t takes slice t (then t + 128, ...),
//   and at step k processes the (k - t)-th slot in level order, so slice
//   s of a slot runs one step after slice s - 1 of it and after slice s of
//   its predecessors.  One barrier a step: B + 127 steps for 128 slices, in
//   place of B x S level steps.
// - Any other fragment runs its slices one after the other and each level's
//   slots on the threads side by side, a barrier a level; end words are
//   kept per slice parity, and a slot reads a predecessor of a lower level
//   from its own slice and any other from the slice before (the
//   reference's masked commit).
// - Per-slot state (Eq words, length, level, the previous slice's column-0
//   bottom score and bottom-row horizontal bits) lives in shared memory
//   (38 B a slot: 152 KB at B = 4096, with the level table 168 KB, past
//   the 48 KB default, so the launch raises the block's limit); end words
//   (16 B a slot and slice) live in the scratch, which stays in L2.
// - Merges are pairwise over the 33 row scores, in registers (no local
//   memory), and skipped where one word provably lies on or above the
//   other on every row: a word whose boundary score is below that of a
//   vertical or free-start word (all insertions down the column) is the
//   merge.  The free-start merge thus runs only where the column's
//   boundary score reaches the free start's (slice 0, and far slots).
// - Columns past a slot's length are not computed (they reach no output).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr int BIG = 1 << 28;
constexpr int IN_NONE = -1;
constexpr int IN_SEED = -2;
constexpr int IN_VERT = -3;
constexpr int NT = 128;                  // threads a block
constexpr uint32_t ONES = 0xFFFFFFFFu;

struct Word {
  uint32_t vp, vn;
  int sb;
};

__device__ __forceinline__ int before_of(const Word& w) {
  return w.sb - __popc(w.vp) + __popc(w.vn);
}

// One Myers column step (ops/myers.advance_word); returns hout.
__device__ __forceinline__ int advance(Word& w, uint32_t eq, int hin) {
  const uint32_t hneg = hin < 0 ? 1u : 0u;
  const uint32_t hpos = hin > 0 ? 1u : 0u;
  eq |= hneg;
  const uint32_t xv = eq | w.vn;
  const uint32_t xh = (((eq & w.vp) + w.vp) ^ w.vp) | eq;
  uint32_t ph = w.vn | ~(xh | w.vp);
  uint32_t mh = w.vp & xh;
  const int hout = (int)(ph >> 31) - (int)(mh >> 31);
  ph = (ph << 1) | hpos;
  mh = (mh << 1) | hneg;
  w.vp = mh | ~(xv | ph);
  w.vn = ph & xv;
  w.sb += hout;
  return hout;
}

// Exact elementwise min of two words over their boundary and 32 row
// scores (ops/myers.merge_words).
__device__ __forceinline__ Word merge2(const Word& a, int ba, const Word& b,
                                       int bb, int& before) {
  int s1 = ba, s2 = bb;
  int prev = min(s1, s2);
  before = prev;
  uint32_t vp = 0, vn = 0;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    s1 += (int)((a.vp >> r) & 1u) - (int)((a.vn >> r) & 1u);
    s2 += (int)((b.vp >> r) & 1u) - (int)((b.vn >> r) & 1u);
    const int m = min(s1, s2);
    const int d = m - prev;
    vp |= (d == 1 ? 1u : 0u) << r;
    vn |= (d == -1 ? 1u : 0u) << r;
    prev = m;
  }
  return Word{vp, vn, prev};
}

__device__ __forceinline__ uint32_t eq_col(const uint4& rq, const uint4& se,
                                           int c) {
  return (((se.x >> c) & 1u) ? rq.x : 0u) | (((se.y >> c) & 1u) ? rq.y : 0u)
       | (((se.z >> c) & 1u) ? rq.z : 0u) | (((se.w >> c) & 1u) ? rq.w : 0u);
}

__device__ __forceinline__ int score_masked(const Word& w, uint32_t m) {
  return w.sb - __popc(w.vp & m) + __popc(w.vn & m);
}

// A fragment's view of its arrays.
struct Frag {
  const int16_t* bin;     // (B, max_in) in-edges
  uint4* ebuf;            // (T, B) end words {vp, vn, sb, -}
  int B, max_in, n_levels;
  int end_slice;          // the slice of the fragment's last row
  uint32_t end_mask;      // rows strictly below the last row
  int base;               // seed_base
  bool full_start;
  // shared memory
  const uint4* seq;       // [B] slot Eq words, seed-trimmed
  const int* slen;        // [B] slot lengths, seed-trimmed
  const int* lvl;         // [B] levels
  int* ssb;               // [B] previous slice: column-0 bottom score
  uint32_t* hp;           // [B]   and bottom-row horizontal +1 / -1 bits
  uint32_t* hn;
};

// Slice s of slot b: column-0 merge, columns, state, end word, best_in and
// (at the end slice) the slot's best end cell.  cur: the end-word buffer
// of slice s; prev: that of slice s - 1 (read for an in-edge that does not
// come from a lower level; the wavefront never has one).
template <typename PTR>
__device__ __forceinline__ void process(const Frag& fr, int b, int s,
                                        const uint4& rq, uint4* cur,
                                        const uint4* prev, PTR* bin_out,
                                        int* end_score, int* end_col) {
  const int len = fr.slen[b];
  const int lb = fr.lvl[b];
  const bool act = len > 0;
  const bool seed = b == 0;
  const uint4 se = fr.seq[b];
  const bool first = s == 0;
  const uint32_t eq0 = eq_col(rq, se, 0);
  const int pssb = first ? BIG : fr.ssb[b];
  const uint32_t php = first ? 0u : fr.hp[b];
  const uint32_t phn = first ? 0u : fr.hn[b];

  // ---- column 0: the merge of the candidates.  Invalid candidates are
  // the word X = (ONES, 0, BIG); the merge starts from I = (0, 0, BIG).
  Word acc{0u, 0u, BIG};
  int acc_b = BIG;
  int nvalid = 0;
  bool acc_src = false;                  // acc is the vertical source word
  bool have_invalid = false;
  int csb = BIG;
  int cbest = IN_NONE;
  auto add = [&](const Word& w, bool valid, int code) {
    if (!valid) { have_invalid = true; return; }
    if (w.sb < csb) { cbest = code; csb = w.sb; }
    const int bw = before_of(w);
    if (nvalid == 0) {
      acc = w; acc_b = bw;
    } else if (acc_src && bw <= acc_b) {
      acc = w; acc_b = bw;               // w lies on or below the source
    } else {
      int nb;
      acc = merge2(acc, acc_b, w, bw, nb);
      acc_b = nb;
    }
    acc_src = false;
    ++nvalid;
  };
  if (first) {
    const bool valid = fr.full_start ? (act || seed) : seed;
    Word w{ONES, 0u, fr.base + W};
    advance(w, eq0, 1);
    add(w, valid, IN_SEED);
  } else {
    const bool valid = act && pssb < BIG;
    add(Word{ONES, 0u, pssb + W}, valid, IN_VERT);
    acc_src = valid;
  }
  for (int e = 0; e < fr.max_in; ++e) {
    const int u = fr.bin[(size_t)b * fr.max_in + e];
    if (u < 0 || !act) { have_invalid = true; continue; }
    const int uc = min(u, fr.B - 1);
    const int lu = fr.lvl[uc];
    if (lu < 0 || lu >= fr.n_levels) { have_invalid = true; continue; }
    uint4 ew;
    if (lu < lb) {
      ew = cur[uc];
    } else if (!first) {
      ew = prev[uc];
    } else {
      have_invalid = true;               // the initial end word
      continue;
    }
    Word w{ew.x, ew.y, (int)ew.z};
    if (w.sb >= BIG) { have_invalid = true; continue; }
    int hin = 1;
    if (!first && pssb < BIG) {
      hin = min(max(pssb - before_of(w), -1), 1);
    }
    advance(w, eq0, hin);
    add(w, true, u);
  }
  if (nvalid == 0) {
    acc = have_invalid ? Word{ONES, 0u, BIG} : Word{0u, 0u, BIG};
    acc_b = have_invalid ? BIG - W : BIG;
  } else if (acc_b > BIG - W) {
    // a word this high is not below X (or I) on every row
    const Word x = have_invalid ? Word{ONES, 0u, BIG} : Word{0u, 0u, BIG};
    int nb;
    acc = merge2(acc, acc_b, x, have_invalid ? BIG - W : BIG, nb);
    acc_b = nb;
  }
  if (first && seed && len == 0) {
    acc = Word{ONES, 0u, fr.base + W};
    acc_b = fr.base;
    cbest = IN_SEED;
  }
  *bin_out = (PTR)cbest;
  fr.ssb[b] = acc.sb;

  // ---- columns 1 .. len - 1
  const bool at_end = s == fr.end_slice;
  int best_sc = (at_end && act) ? score_masked(acc, fr.end_mask) : BIG;
  int best_cl = 0;
  Word w = acc;
  int wb = acc_b;
  Word ew = len <= 1 ? w : Word{0u, 0u, BIG};
  uint32_t hp_acc = 0u, hn_acc = 0u;
  const int fbase = fr.base + W * s;
  const int last = min(len, W) - 1;
  for (int c = 1; c <= last; ++c) {
    const uint32_t eqc = eq_col(rq, se, c);
    const int hin = first ? 1 : (int)((php >> c) & 1u) - (int)((phn >> c) & 1u);
    const int hout = advance(w, eqc, hin);
    wb += hin;
    hp_acc |= (hout > 0 ? 1u : 0u) << c;
    hn_acc |= (hout < 0 ? 1u : 0u) << c;
    if (fr.full_start && wb >= fbase) {
      // the free-start word: the all-insertion column of score fbase,
      // advanced into this column; below fbase it cannot win a row
      Word f{ONES, 0u, fbase + W};
      advance(f, eqc, first ? 0 : 1);
      int nb;
      w = merge2(w, wb, f, before_of(f), nb);
      wb = nb;
    }
    if (at_end) {
      const int sr = score_masked(w, fr.end_mask);
      if (sr < best_sc) { best_sc = sr; best_cl = c; }
    }
    if (c == len - 1) ew = w;
  }
  if (!(act || (seed && len == 0))) ew.sb = BIG;
  fr.hp[b] = hp_acc;
  fr.hn[b] = hn_acc;
  cur[b] = make_uint4(ew.vp, ew.vn, (uint32_t)ew.sb, 0u);
  if (at_end && best_sc < BIG) {
    end_score[b] = best_sc;
    end_col[b] = best_cl;
  }
}

template <typename PTR>
__global__ void __launch_bounds__(NT)
frag_wide_kernel(const uint4* __restrict__ node_eq,        // (N2, 4)
                 const int* __restrict__ node_len,         // (N2,)
                 const int* __restrict__ band_nodes,       // (F, B)
                 const int16_t* __restrict__ band_in,      // (F, B, max_in)
                 const int* __restrict__ band_level,       // (F, B)
                 const int* __restrict__ seed_shift,       // (F,)
                 const uint4* __restrict__ req,            // (F, S, 4)
                 const int* __restrict__ rows,             // (F,)
                 const int* __restrict__ seed_base,        // (F,) or null
                 int N2, int B, int S, int max_in, int n_levels,
                 int full_start, int T,
                 uint4* __restrict__ scratch,              // (F, T, B)
                 int* __restrict__ best_score, int* __restrict__ best_slot,
                 int* __restrict__ best_col,
                 PTR* __restrict__ best_in,                // (F, B, S)
                 int* __restrict__ end_score,              // (F, B)
                 int* __restrict__ end_col) {              // (F, B)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f = blockIdx.x;
  const int t = threadIdx.x;
  uint4* seq = (uint4*)smem_raw;
  int* slen = (int*)(seq + B);
  int* lvl = slen + B;
  int* ssb = lvl + B;
  uint32_t* hp = (uint32_t*)(ssb + B);
  uint32_t* hn = hp + B;
  int* cur = (int*)(hn + B);             // [n_levels] level ends
  uint16_t* order = (uint16_t*)(cur + n_levels + 1);
  __shared__ int red_s[NT];
  __shared__ int red_b[NT];

  const size_t fb = (size_t)f * B;
  const int fr_rows = rows[f];
  PTR* bin_f = best_in + fb * S;
  int* es_f = end_score + fb;
  int* ec_f = end_col + fb;

  // ---- the fragment's slots
  for (int i = t; i <= n_levels; i += NT) cur[i] = 0;
  __syncthreads();
  for (int b = t; b < B; b += NT) {
    const int id = band_nodes[fb + b];
    const int idc = min(max(id, 0), N2 - 1);
    uint4 e = node_eq[idc];
    int len = id >= 0 ? node_len[idc] : 0;
    if (b == 0) {
      const int ss = seed_shift[f];
      const uint32_t sh = (uint32_t)ss & 31u;
      e.x >>= sh; e.y >>= sh; e.z >>= sh; e.w >>= sh;
      len -= ss;
    }
    seq[b] = e;
    slen[b] = len;
    const int l = band_level[fb + b];
    lvl[b] = l;
    es_f[b] = BIG;
    ec_f[b] = 0;
    if (l >= 0 && l < n_levels) {
      atomicAdd(&cur[l], 1);
    } else {
      for (int s = 0; s < S; ++s) bin_f[(size_t)b * S + s] = (PTR)IN_NONE;
    }
  }
  __syncthreads();
  // exclusive scan of the level counts: chunks of NT threads
  {
    const int chunk = (n_levels + NT - 1) / NT;
    const int lo = min(t * chunk, n_levels), hi = min(lo + chunk, n_levels);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += cur[i];
    red_s[t] = sum;
    __syncthreads();
    if (t == 0) {
      int run = 0;
      for (int i = 0; i < NT; ++i) { const int v = red_s[i]; red_s[i] = run; run += v; }
    }
    __syncthreads();
    int run = red_s[t];
    for (int i = lo; i < hi; ++i) { const int v = cur[i]; cur[i] = run; run += v; }
  }
  __syncthreads();
  // scatter: cur[l] ends at the end of level l; regular: every in-edge
  // that can be valid comes from a lower level
  int irregular = 0;
  for (int b = t; b < B; b += NT) {
    const int l = lvl[b];
    if (l < 0 || l >= n_levels) continue;
    order[atomicAdd(&cur[l], 1)] = (uint16_t)b;
    for (int e = 0; e < max_in; ++e) {
      const int u = band_in[(fb + b) * max_in + e];
      if (u < 0) continue;
      const int lu = lvl[min(u, B - 1)];
      if (lu >= 0 && lu < n_levels && lu >= l) irregular = 1;
    }
  }
  irregular = __syncthreads_or(irregular);
  const int n_proc = n_levels > 0 ? cur[n_levels - 1] : 0;

  Frag fr;
  fr.bin = band_in + fb * max_in;
  fr.ebuf = scratch + (size_t)f * T * B;
  fr.B = B; fr.max_in = max_in; fr.n_levels = n_levels;
  fr.end_slice = (fr_rows - 1) >= 0 ? (fr_rows - 1) / W : -1;
  {
    const int er = ((fr_rows - 1) % W + W) % W;
    fr.end_mask = er < W - 1 ? (ONES << (er + 1)) : 0u;
  }
  fr.base = seed_base != nullptr ? seed_base[f] : 0;
  fr.full_start = full_start != 0;
  fr.seq = seq; fr.slen = slen; fr.lvl = lvl;
  fr.ssb = ssb; fr.hp = hp; fr.hn = hn;

  if (!irregular) {
    // the slice wavefront: thread t runs slice r * NT + t
    for (int r0 = 0; r0 < S; r0 += NT) {
      const int s = r0 + t;
      const int lanes = min(NT, S - r0);
      const uint4 rq = s < S ? req[(size_t)f * S + s] : make_uint4(0, 0, 0, 0);
      uint4* eb = fr.ebuf + (size_t)min(t, T - 1) * B;
      const int steps = n_proc + lanes - 1;
      for (int k = 0; k < steps; ++k) {
        const int p = k - t;
        if (t < lanes && p >= 0 && p < n_proc) {
          const int b = order[p];
          process<PTR>(fr, b, s, rq, eb, eb, bin_f + (size_t)b * S + s,
                       es_f, ec_f);
        }
        __syncthreads();
      }
    }
  } else {
    // level by level: the level's slots side by side
    for (int s = 0; s < S; ++s) {
      const uint4 rq = req[(size_t)f * S + s];
      uint4* eb = fr.ebuf + (size_t)(s & 1) * B;
      const uint4* pb = fr.ebuf + (size_t)((s + 1) & 1) * B;
      for (int l = 0; l < n_levels; ++l) {
        const int st = l == 0 ? 0 : cur[l - 1];
        const int en = cur[l];
        if (st == en) continue;
        for (int i = st + t; i < en; i += NT) {
          const int b = order[i];
          process<PTR>(fr, b, s, rq, eb, pb, bin_f + (size_t)b * S + s,
                       es_f, ec_f);
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();

  // ---- the best slot: lowest end score, then lowest slot
  int bs = BIG + 1, bb = 0;
  for (int b = t; b < B; b += NT) {
    const int v = es_f[b];
    if (v < bs) { bs = v; bb = b; }
  }
  red_s[t] = bs;
  red_b[t] = bb;
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (t < h) {
      const int v = red_s[t + h], vb = red_b[t + h];
      if (v < red_s[t] || (v == red_s[t] && vb < red_b[t])) {
        red_s[t] = v;
        red_b[t] = vb;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    best_score[f] = red_s[0];
    best_slot[f] = red_b[0];
    best_col[f] = ec_f[red_b[0]];
  }
}

// Dynamic shared memory of a block.
inline size_t smem_bytes(int B, int n_levels) {
  return (size_t)B * (16 + 4 + 4 + 4 + 4 + 4) + (size_t)(n_levels + 1) * 4
       + (size_t)B * 2;
}

template <typename PTR>
cudaError_t launch(const void* node_eq, const void* node_len,
                   const void* band_nodes, const void* band_in,
                   const void* band_level, const void* seed_shift,
                   const void* req, const void* rows, const void* seed_base,
                   int N2, int F, int B, int S, int max_in, int n_levels,
                   int full_start, int T, void* scratch, void* best_score,
                   void* best_slot, void* best_col, void* best_in,
                   void* end_score, void* end_col, cudaStream_t stream) {
  const size_t bytes = smem_bytes(B, n_levels);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frag_wide_kernel<PTR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  frag_wide_kernel<PTR><<<F, NT, bytes, stream>>>(
      (const uint4*)node_eq, (const int*)node_len, (const int*)band_nodes,
      (const int16_t*)band_in, (const int*)band_level,
      (const int*)seed_shift, (const uint4*)req, (const int*)rows,
      (const int*)seed_base, N2, B, S, max_in, n_levels, full_start, T,
      (uint4*)scratch, (int*)best_score, (int*)best_slot, (int*)best_col,
      (PTR*)best_in, (int*)end_score, (int*)end_col);
  return cudaGetLastError();
}

}  // namespace

// best_in is int8 for B <= 127, else int16; seed_base may be null (0).
extern "C" int frag_wide_launch(const void* node_eq, const void* node_len,
                                const void* band_nodes, const void* band_in,
                                const void* band_level,
                                const void* seed_shift, const void* req,
                                const void* rows, const void* seed_base,
                                int N2, int F, int B, int S, int max_in,
                                int n_levels, int full_start, int T,
                                void* scratch, void* best_score,
                                void* best_slot, void* best_col,
                                void* best_in, void* end_score,
                                void* end_col, void* stream) {
  if (F <= 0) return 0;
  if (B < 1 || B > 4096 || S < 1 || max_in < 0 || N2 < 1 || n_levels < 1
      || n_levels > 4096 || T != (S < 2 ? 2 : (S < NT ? S : NT)))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto launcher) {
    return launcher(node_eq, node_len, band_nodes, band_in, band_level,
                    seed_shift, req, rows, seed_base, N2, F, B, S, max_in,
                    n_levels, full_start, T, scratch, best_score, best_slot,
                    best_col, best_in, end_score, end_col,
                    (cudaStream_t)stream);
  };
  const cudaError_t err = B <= 127 ? go(launch<int8_t>) : go(launch<int16_t>);
  return (int)err;
}
