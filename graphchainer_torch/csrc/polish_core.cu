// Banded linear Myers fill of each read against its stitched path (polish).
//
// Replaces: graphchainer_tpu/ops/pallas_polish2.py::polish_core_pallas
// (body _kernel).  Computes exactly graphchainer_torch/ops/linear_align.py
// _polish_core_t (= the JAX _polish_core_t): bw words of 32 read rows in a
// diagonal band that follows the read/path length ratio column by column
// (band_base, float32), advanced with the Myers recurrence; every column's
// band words are dumped for the score and the backtrace.
//
// Two entries, chosen by bw alone in ops/polish_kernel.py:
//
// polish_core_launch (bw 8, 16, 32): one warp per read, one lane per band
// word, the columns as a skewed wavefront.  Absolute word a (rows 32a ..
// 32a + 31) sits on lane a mod BW and handles column p at step p + a.  By
// then its own state after column p - 1 (step p + a - 1, same lane) and the
// horizontal carry of word a - 1 at column p (step p + a - 1, the
// neighbour lane, one __shfl_sync) are both ready.  band_base is monotone
// in the column, so the band's top word at column p is band_base(p) in
// closed form: each lane evaluates it for its own column, and a word that
// leaves the band frees its lane for word a + BW, which enters BW steps
// later from the all-insertion fill (sb = the old bottom word's sb after
// the previous column + 32; the neighbour lane keeps that value one step
// longer for it).  No state moves between lanes on a band shift.  The
// read's plane words stay in registers while a lane keeps its word; the
// path's column masks are staged by the whole warp, coalesced, into a
// shared-memory ring 256 steps ahead, so nothing on the carry chain waits
// for device memory.  The dump is stored read-major, [read][col][word]
// (the wrapper hands out (P, bw, R) views): a column's words are
// contiguous, which is what the walk kernel stages.
//   A band that can move more than one word in a column (read more than 16
// times longer than its path: scale > 16) needs the old bottom's sb from
// several columns back; such a read runs the serial loop on lane 0 of its
// warp, inside the same kernel, into the same layout.
//   What bounds it on the H100: the P + RW + BW steps of the wavefront.
// A step is ~80 instructions issued by one warp alone on its scheduler,
// with little but its own instructions to hide their latencies behind; the
// carry chain itself (the shuffle and ~10 dependent integer ops) is a
// fraction of a step.  So the lane's bookkeeping for the coming step (is
// its word in the band, the band's top, the match bits) is worked out
// one step ahead, as straight-line code beside the carry chain.  The time
// does not move with the number of reads up to one warp per SM, nor from
// bw 8 to 16; at bw 32 the dump's stores (12 bytes per word per column,
// one sector per lane and store) take over.  The dump's bytes at the
// memory rate lie an order of magnitude and more below (PERF.md).
//
// polish_core_any_launch (any bw >= 1, the band width a run-time argument;
// the wrapper takes it for every width but 8, 16 and 32, which the
// --polish-band ramp from another start reaches: 3 -> 6 -> 12 -> 24 -> 48,
// and 17-31 -> 34-62): up to 64 words, the same skewed wavefront, a warp
// per read, the lane of word a being a mod bw with no power-of-two mask,
// and past 32 words two words a lane (polish_core_any_kernel<2>), run
// side by side; the dump read-major, [read][col][word], with the word
// stride ws = bw rounded up to a multiple of 4 (the padding words are
// never written), so each column starts on 16 bytes and polish_walk's warp
// walk stages it as it stages the template entries' dump.  Steep bands
// take the serial fill on lane 0, as in the warp entries, here the one
// below.  Past 64 words (an explicit --polish-band above 64): one thread
// per read (polish_core_thread_kernel) keeps no band state of its own:
// word w of column col starts from word w + shift of column col - 1, read
// back from the dump where the same thread wrote it one column earlier;
// that dump is column-major, [col][word][read], so the threads' loads and
// stores are coalesced across reads.  What bounds the warp entries: the
// P + RW + bw steps of the wavefront, a step ~80 instructions (twice that
// with two words a lane) of one warp alone on its scheduler; the
// thread-per-read route: P x bw dependent word steps per read, each
// waiting on a cached load of the word written a column before; the bytes
// lie far below either (PERF.md).
//
// Both load the band's plane words directly: the Pallas kernel's rolling
// window (bw + WIN_EXTRA plane words, rolled by a one-word shift, refilled
// at the band's top on a larger shift or when fewer than bw words remain)
// only ever exposes its first bw words, which equal the planes at the
// band's rows, except at bw = 1: there the shift is clamped to one word
// before the refill test, so a band that jumps two or more words in a
// column leaves the window behind until it runs out.  A jump like that
// happens only above scale 16, in the serial fill, which keeps the
// window's first row word as the reference does.  band_base rounds as
// JAX float32 does: __fdiv_rn / __fmul_rn, truncation toward 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr int WIN_EXTRA = 8;               // ops/linear_align.WIN_EXTRA
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int advance(uint32_t& vp, uint32_t& vn, int& sb,
                                       uint32_t eq, int hin) {
  const uint32_t hneg = hin < 0 ? 1u : 0u;
  const uint32_t hpos = hin > 0 ? 1u : 0u;
  eq |= hneg;
  const uint32_t xv = eq | vn;
  const uint32_t xh = (((eq & vp) + vp) ^ vp) | eq;
  uint32_t ph = vn | ~(xh | vp);
  uint32_t mh = vp & xh;
  const int hout = (int)(ph >> 31) - (int)(mh >> 31);
  ph = (ph << 1) | hpos;
  mh = (mh << 1) | hneg;
  vp = mh | ~(xv | ph);
  vn = ph & xv;
  sb += hout;
  return hout;
}

// The band's top word per column: a closed form of the column, monotone.
struct Band {
  int pl1, ub, half;
  float scale;
  __device__ Band(int rlen, int plen, int bw) {
    pl1 = max(plen, 1);
    const int rw_cap = (rlen + W - 1) / W;   // read_len >= 0
    ub = max(rw_cap - bw, 0);
    half = bw / 2;
    scale = __fdiv_rn((float)rlen, (float)pl1);
  }
  __device__ __forceinline__ int base(int col) const {
    const int cc = min(col, pl1 - 1);
    const float target = __fmul_rn((float)(cc + 1), scale);
    const int b = (int)__fmul_rn(target, 1.0f / W) - half;
    return min(max(b, 0), ub);
  }
};

// Where word w of column col of read r lies in a read-major dump (the
// template entries' layout).
__device__ __forceinline__ size_t dump_at(int col, int w, int r, int P,
                                          int bw) {
  return ((size_t)r * P + col) * bw + w;
}

// The match bits of band row word row_w against path mask pmm.
__device__ __forceinline__ uint32_t eq_of(const uint32_t* __restrict__ planes,
                                          uint32_t pmm, int row_w, int r,
                                          int R, int RW) {
  uint32_t eq = 0;
  if (row_w < RW) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((pmm >> k) & 1u) eq |= planes[((size_t)k * RW + row_w) * R + r];
  }
  return eq;
}

// One read, column by column, by one thread, band state in registers: the
// warp entry's route for a read whose band moves several words a column.
template <int BW>
__device__ void fill_serial(const uint32_t* __restrict__ planes,
                            const uint32_t* __restrict__ path,
                            int rlen, int plen, int r, int R, int RW, int P,
                            uint32_t* __restrict__ dvp,
                            uint32_t* __restrict__ dvn,
                            int* __restrict__ dsb, int* __restrict__ dbase) {
  const Band band(rlen, plen, BW);
  uint32_t vp[BW], vn[BW];
  int sb[BW];
  int base = band.base(0);
#pragma unroll
  for (int w = 0; w < BW; ++w) {
    vp[w] = ONES; vn[w] = 0; sb[w] = base * W + (w + 1) * W;
  }

  for (int col = 0; col < P; ++col) {
    const uint32_t pmm = path[(size_t)col * R + r];
    const int nb = max(band.base(col), base);
    const int shift = min(max(nb - base, 0), BW);
    const int bot = sb[BW - 1];
    for (int t = 0; t < shift; ++t) {      // slide the band by one word
#pragma unroll
      for (int w = 0; w < BW - 1; ++w) {
        vp[w] = vp[w + 1]; vn[w] = vn[w + 1]; sb[w] = sb[w + 1];
      }
      vp[BW - 1] = ONES; vn[BW - 1] = 0; sb[BW - 1] = bot + (t + 1) * W;
    }
    int hin = 1;
#pragma unroll
    for (int w = 0; w < BW; ++w) {
      hin = advance(vp[w], vn[w], sb[w], eq_of(planes, pmm, nb + w, r, R, RW),
                    hin);
      const size_t o = dump_at(col, w, r, P, BW);
      dvp[o] = vp[w];
      dvn[o] = vn[w];
      dsb[o] = sb[w];
    }
    dbase[(size_t)r * P + col] = nb;
    base = nb;
  }
}

// Where word w of column col of read r lies in a run-time-bw dump, and
// column col's band base: read-major with word stride ws (bw rounded up
// to a multiple of 4) up to 64 words, column-major beyond.
struct Layout {
  size_t rs, cs, wsd;    // strides of read, column, word
  size_t brs, bcs;       // strides of read, column in dbase
  __device__ __forceinline__ size_t at(int r, int col, int w) const {
    return r * rs + col * cs + w * wsd;
  }
  __device__ __forceinline__ size_t base_at(int r, int col) const {
    return r * brs + col * bcs;
  }
  __device__ static Layout read_major(int P, int bw) {
    const size_t ws = (size_t)((bw + 3) & ~3);
    return Layout{(size_t)P * ws, ws, 1, (size_t)P, 1};
  }
  __device__ static Layout col_major(int R, int bw) {
    return Layout{1, (size_t)bw * R, (size_t)R, 1, (size_t)R};
  }
};

// One read, column by column, by one thread, with the band width a
// run-time argument: the thread keeps no band state of its own; word w of
// column col starts from word w + shift of column col - 1, read back from
// the dump where the same thread wrote it one column earlier (shift: how
// far the band's top moved, at most bw), or, below the old bottom word,
// from the all-insertion fill (its sb + 32 per word).  The dump pointers
// are read as well as written, so they are neither const nor __restrict__:
// no load may take the read-only path.
__device__ void fill_any_serial(const uint32_t* __restrict__ planes,
                                const uint32_t* __restrict__ path,
                                int rlen, int plen, int r, int R, int RW,
                                int P, int bw, const Layout& L,
                                uint32_t* dvp, uint32_t* dvn, int* dsb,
                                int* __restrict__ dbase) {
  const Band band(rlen, plen, bw);
  auto at = [&](int col, int w) { return L.at(r, col, w); };
  int base = band.base(0);
  // the reference's plane window: its first row word and the words it
  // still holds (see the note above: it lags the band only at bw = 1)
  int wbase = base, valid = bw + WIN_EXTRA;
  for (int col = 0; col < P; ++col) {
    const uint32_t pmm = path[(size_t)col * R + r];
    const int nb = max(band.base(col), base);
    const int shift = min(max(nb - base, 0), bw);
    valid -= shift;
    if (shift > 1 || valid < bw) {
      wbase = nb;
      valid = bw + WIN_EXTRA;
    } else {
      wbase += shift;
    }
    const int bot = col ? dsb[at(col - 1, bw - 1)] : 0;
    int hin = 1;
#pragma unroll 4
    for (int w = 0; w < bw; ++w) {
      const int j = w + shift;
      uint32_t vp = ONES, vn = 0;
      int sb;
      if (col == 0) {                 // the boundary column's words
        sb = base * W + (w + 1) * W;
      } else if (j < bw) {            // the word that held these rows
        const size_t o = at(col - 1, j);
        vp = dvp[o];
        vn = dvn[o];
        sb = dsb[o];
      } else {                        // below the old bottom word
        sb = bot + (j - bw + 1) * W;
      }
      hin = advance(vp, vn, sb, eq_of(planes, pmm, wbase + w, r, R, RW),
                    hin);
      const size_t o = at(col, w);
      dvp[o] = vp;
      dvn[o] = vn;
      dsb[o] = sb;
    }
    dbase[L.base_at(r, col)] = nb;
    base = nb;
  }
}

// The run-time-bw entry beyond 64 words: a thread per read.
__global__ void __launch_bounds__(64)
polish_core_thread_kernel(const uint32_t* __restrict__ planes, // (4, RW, R)
                          const uint32_t* __restrict__ path,   // (P, R)
                          const int* __restrict__ read_len,    // (R,)
                          const int* __restrict__ path_len,    // (R,)
                          int R, int RW, int P, int bw,
                          uint32_t* dvp,                       // (P, bw, R)
                          uint32_t* dvn,                       // (P, bw, R)
                          int* dsb,                            // (P, bw, R)
                          int* __restrict__ dbase) {           // (P, R)
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  fill_any_serial(planes, path, read_len[r], path_len[r], r, R, RW, P, bw,
                  Layout::col_major(R, bw), dvp, dvn, dsb, dbase);
}

constexpr int RING_STEPS = 256;            // steps between ring refills
constexpr int RING = 2 * RING_STEPS;       // path masks held (>= steps + BW)
constexpr float MAX_WAVE_SCALE = 16.0f;    // above: shifts of > 1 word

template <int BW>
__global__ void __launch_bounds__(32)
polish_core_warp_kernel(const uint32_t* __restrict__ planes,   // (4, RW, R)
                        const uint32_t* __restrict__ path,     // (P, R)
                        const int* __restrict__ read_len,      // (R,)
                        const int* __restrict__ path_len,      // (R,)
                        int R, int RW, int P,
                        uint32_t* __restrict__ dvp,            // (R, P, BW)
                        uint32_t* __restrict__ dvn,            // (R, P, BW)
                        int* __restrict__ dsb,                 // (R, P, BW)
                        int* __restrict__ dbase) {             // (R, P)
  static_assert(BW >= 2 && BW <= 32 && RING > RING_STEPS + BW, "band");
  __shared__ uint8_t ring[RING];
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int rlen = read_len[r];
  const int plen = path_len[r];
  const Band band(rlen, plen, BW);
  // target moves by `scale` rows a column: up to 16 (plus float rounding
  // far below 16) that is at most half a word, so the band's top moves by
  // 0 or 1 words.  Beyond it, the read takes the serial loop.
  if (!(band.scale <= MAX_WAVE_SCALE)) {
    if (lane == 0)
      fill_serial<BW>(planes, path, rlen, plen, r, R, RW, P, dvp, dvn, dsb,
                      dbase);
    return;
  }

  auto load_planes = [&](int a, uint32_t (&pw)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      pw[k] = (a >= 0 && a < RW) ? planes[((size_t)k * RW + a) * R + r] : 0u;
  };

  const int base0 = band.base(0);
  const int s_end = P - 1 + band.base(P - 1) + BW - 1;   // last step
  // this lane's word: the first a >= base0 with a mod BW == lane; lanes
  // past the band never reach a column (p stays negative)
  int a = lane < BW ? base0 + ((lane - base0) & (BW - 1)) : (1 << 29);
  uint32_t pw[4];
  load_planes(lane < BW ? a : -1, pw);
  uint32_t vp = ONES, vn = 0;
  int sb = 0, sb_prev = 0, hout = 0;
  bool fresh = true;              // the word has not taken a column yet
  int fill_hi = 0;                // first path column not yet in the ring
  const int src = (lane - 1) & (BW - 1);

  // What the lane does at the coming step is worked out one step ahead
  // (is its word in the band at its column, the band's top there, the
  // match bits), beside the carry chain of the step before and not in
  // front of it: both are straight-line code in one block, so their
  // instructions fill each other's latencies.
  bool act = false;               // the word takes column p at this step
  int p = 0, nb = 0;
  uint32_t eq = 0;
  auto prepare = [&](int s) {
    p = s - a;
    const bool inside = p >= 0 && p < P;
    nb = band.base(min(max(p, 0), P - 1));
    const bool left = inside && a < nb;
    act = inside && !left && a < nb + BW;
    const uint32_t pmm = ring[p & (RING - 1)];
    eq = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) eq |= ((pmm >> k) & 1u) ? pw[k] : 0u;
    if (left) {                   // left the band: take the next word,
      a += BW;                    // which enters BW steps from now
      fresh = true;
      load_planes(a, pw);
    }
  };

  for (int S = base0; S <= s_end; S += RING_STEPS) {
    // Column p is first used at step p + base(p) and read one step
    // earlier, so the steps up to S + RING_STEPS - 1 read no column past
    // S + RING_STEPS - base(fill_hi); a column is last used BW - 1 steps
    // after its first, so the slot it overwrites (RING columns back) is
    // done.
    __syncwarp();
    const int hi = min(P, S + RING_STEPS + 1
                              - band.base(min(fill_hi, P - 1)));
    for (int c = fill_hi + lane; c < hi; c += 32)
      ring[c & (RING - 1)] = (uint8_t)path[(size_t)c * R + r];
    fill_hi = max(fill_hi, hi);
    __syncwarp();
    if (S == base0) prepare(S);

    const int Se = min(S + RING_STEPS - 1, s_end);
    for (int s = S; s <= Se; ++s) {
      // the neighbour's carry (-1, 0, 1) and its sb before its last
      // column, in one shuffle
      const int nbr = __shfl_sync(FULL, sb_prev * 4 + (hout + 1), src);
      // column 0 starts from the boundary column; a word that enters
      // below the old bottom continues its all-insertion run
      const bool start = act && fresh;
      uint32_t v_p = start ? ONES : vp;
      uint32_t v_n = start ? 0u : vn;
      int v_s = start ? (p == 0 ? (a + 1) * W : (nbr >> 2) + W) : sb;
      const int before = v_s;
      const int hin = a == nb ? 1 : (nbr & 3) - 1;
      const int h = advance(v_p, v_n, v_s, eq, hin);
      if (act) {
        vp = v_p; vn = v_n; sb = v_s;
        sb_prev = before;
        hout = h;
        fresh = false;
        const size_t o = dump_at(p, a - nb, r, P, BW);
        dvp[o] = v_p;
        dvn[o] = v_n;
        dsb[o] = v_s;
        if (a == nb) dbase[(size_t)r * P + p] = nb;
      }
      prepare(s + 1);
    }
  }
}

// The run-time-bw warp entry: the template warp entries' skewed
// wavefront (see polish_core_warp_kernel) with the band width a run-time
// argument, for bw 1..64.  Word a sits on lane a mod bw and, past 32
// words, lane (a mod bw) - 32 holds it as its second word (WORDS = 2), so
// each lane runs one or two words a step, side by side.  The carry of
// word a - 1 at column p comes by one shuffle per word: word a - 1 of a
// lane's first word is the first word of the lane below, except on lane
// 0, whose first word (a mod bw = 0) follows word bw - 1 (the second word
// of lane bw - 33, or, with one word a lane, the first of lane bw - 1) and
// whose second word (32) follows word 31 (lane 31's first).  Two words a
// lane rather than two warps a read: the carry stays a shuffle, with no
// barrier between warps at every step, and the two words' steps are
// independent instructions that fill each other's latencies.  The dump is
// written read-major with word stride ws (Layout::read_major), the layout
// polish_walk's warp walk stages.
template <int WORDS>
__global__ void __launch_bounds__(32)
polish_core_any_kernel(const uint32_t* __restrict__ planes,   // (4, RW, R)
                       const uint32_t* __restrict__ path,     // (P, R)
                       const int* __restrict__ read_len,      // (R,)
                       const int* __restrict__ path_len,      // (R,)
                       int R, int RW, int P, int bw,
                       uint32_t* dvp,                         // (R, P, ws)
                       uint32_t* dvn,                         // (R, P, ws)
                       int* dsb,                              // (R, P, ws)
                       int* __restrict__ dbase) {             // (R, P)
  __shared__ uint8_t ring[RING];
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int rlen = read_len[r];
  const int plen = path_len[r];
  const Band band(rlen, plen, bw);
  if (!(band.scale <= MAX_WAVE_SCALE)) {
    if (lane == 0)
      fill_any_serial(planes, path, rlen, plen, r, R, RW, P, bw,
                      Layout::read_major(P, bw), dvp, dvn, dsb, dbase);
    return;
  }
  const int ws = (bw + 3) & ~3;               // the dump's word stride

  // per word slot k of this lane: its absolute word a (residue lane +
  // 32k), plane words, state, and what it does at the coming step
  struct Slot {
    int a, p, nb, sb, sb_prev, hout;
    uint32_t vp, vn, eq, pw[4];
    bool fresh, act;
  };
  Slot w[WORDS];
  const int base0 = band.base(0);
  const int s_end = P - 1 + band.base(P - 1) + bw - 1;   // last step
  auto load_planes = [&](Slot& x) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x.pw[k] = (x.a >= 0 && x.a < RW) ? planes[((size_t)k * RW + x.a) * R + r]
                                       : 0u;
  };
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int q = lane + 32 * k;            // residue
    w[k].a = q < bw ? base0 + (((q - base0) % bw) + bw) % bw : (1 << 29);
    load_planes(w[k]);
    w[k].vp = ONES; w[k].vn = 0u;
    w[k].sb = 0; w[k].sb_prev = 0; w[k].hout = 0;
    w[k].fresh = true; w[k].act = false;
    w[k].p = 0; w[k].nb = 0; w[k].eq = 0u;
  }
  // the lane of word a - 1 for this lane's first word
  const int src0 = lane == 0 ? (bw - 1) & 31 : lane - 1;
  int fill_hi = 0;

  auto prepare = [&](int s) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      Slot& x = w[k];
      x.p = s - x.a;
      const bool inside = x.p >= 0 && x.p < P;
      x.nb = band.base(min(max(x.p, 0), P - 1));
      const bool left = inside && x.a < x.nb;
      x.act = inside && !left && x.a < x.nb + bw;
      const uint32_t pmm = ring[x.p & (RING - 1)];
      uint32_t eq = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) eq |= ((pmm >> j) & 1u) ? x.pw[j] : 0u;
      x.eq = eq;
      if (left) {                   // left the band: take the next word,
        x.a += bw;                  // which enters bw steps from now
        x.fresh = true;
        load_planes(x);
      }
    }
  };

  for (int S = base0; S <= s_end; S += RING_STEPS) {
    __syncwarp();
    const int hi = min(P, S + RING_STEPS + 1
                              - band.base(min(fill_hi, P - 1)));
    for (int c = fill_hi + lane; c < hi; c += 32)
      ring[c & (RING - 1)] = (uint8_t)path[(size_t)c * R + r];
    fill_hi = max(fill_hi, hi);
    __syncwarp();
    if (S == base0) prepare(S);

    const int Se = min(S + RING_STEPS - 1, s_end);
    for (int s = S; s <= Se; ++s) {
      // each word's carry (-1, 0, 1) and its sb before its last column
      int nbr[WORDS];
      const int c0 = w[0].sb_prev * 4 + (w[0].hout + 1);
      if (WORDS == 1) {
        nbr[0] = __shfl_sync(FULL, c0, src0);
      } else {
        const int c1 = w[WORDS - 1].sb_prev * 4 + (w[WORDS - 1].hout + 1);
        const int x = __shfl_sync(FULL, c0, (lane - 1) & 31);
        const int y = __shfl_sync(FULL, c1, lane == 0 ? src0 : lane - 1);
        nbr[0] = lane ? x : y;
        nbr[WORDS - 1] = lane ? y : x;
      }
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        Slot& x = w[k];
        // column 0 starts from the boundary column; a word that enters
        // below the old bottom continues its all-insertion run
        const bool start = x.act && x.fresh;
        uint32_t v_p = start ? ONES : x.vp;
        uint32_t v_n = start ? 0u : x.vn;
        // (with one band word, the old bottom is this slot's own word,
        // whose sb after its last column is still x.sb)
        const int bot = (WORDS == 1 && bw == 1) ? x.sb : nbr[k] >> 2;
        int v_s = start ? (x.p == 0 ? (x.a + 1) * W : bot + W) : x.sb;
        const int before = v_s;
        const int hin = x.a == x.nb ? 1 : (nbr[k] & 3) - 1;
        const int h = advance(v_p, v_n, v_s, x.eq, hin);
        if (x.act) {
          x.vp = v_p; x.vn = v_n; x.sb = v_s;
          x.sb_prev = before;
          x.hout = h;
          x.fresh = false;
          const size_t o = ((size_t)r * P + x.p) * ws + (x.a - x.nb);
          dvp[o] = v_p;
          dvn[o] = v_n;
          dsb[o] = v_s;
          if (x.a == x.nb) dbase[(size_t)r * P + x.p] = x.nb;
        }
      }
      prepare(s + 1);
    }
  }
}

struct Args {
  const uint32_t* planes;
  const uint32_t* path;
  const int* read_len;
  const int* path_len;
  int R, RW, P;
  uint32_t* dvp;
  uint32_t* dvn;
  int* dsb;
  int* dbase;
  cudaStream_t stream;
};

template <int BW>
cudaError_t launch_warp(const Args& a) {
  polish_core_warp_kernel<BW><<<a.R, 32, 0, a.stream>>>(
      a.planes, a.path, a.read_len, a.path_len, a.R, a.RW, a.P, a.dvp, a.dvn,
      a.dsb, a.dbase);
  return cudaGetLastError();
}

Args make_args(const void* planes, const void* path, const void* read_len,
               const void* path_len, int R, int RW, int P, void* dvp,
               void* dvn, void* dsb, void* dbase, void* stream) {
  return Args{(const uint32_t*)planes, (const uint32_t*)path,
              (const int*)read_len, (const int*)path_len, R, RW, P,
              (uint32_t*)dvp, (uint32_t*)dvn, (int*)dsb, (int*)dbase,
              (cudaStream_t)stream};
}

}  // namespace

// Warp per read; the dump is written read-major: dvp / dvn / dsb as
// (R, P, bw), dbase as (R, P).
extern "C" int polish_core_launch(const void* planes, const void* path,
                                  const void* read_len, const void* path_len,
                                  int R, int RW, int P, int bw, void* dvp,
                                  void* dvn, void* dsb, void* dbase,
                                  void* stream) {
  if (R <= 0 || P <= 0) return 0;
  const Args a = make_args(planes, path, read_len, path_len, R, RW, P, dvp,
                           dvn, dsb, dbase, stream);
  switch (bw) {
    case 8: return (int)launch_warp<8>(a);
    case 16: return (int)launch_warp<16>(a);
    case 32: return (int)launch_warp<32>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Any bw >= 1.  Up to 64 words a warp per read (one word a lane up to 32,
// two beyond), the dump written read-major with word stride ws = bw
// rounded up to a multiple of 4: dvp / dvn / dsb as (R, P, ws), dbase as
// (R, P).  Past 64 a thread per read, the dump column-major: dvp / dvn /
// dsb as (P, bw, R), dbase as (P, R).
extern "C" int polish_core_any_launch(const void* planes, const void* path,
                                      const void* read_len,
                                      const void* path_len, int R, int RW,
                                      int P, int bw, void* dvp, void* dvn,
                                      void* dsb, void* dbase, void* stream) {
  if (R <= 0 || P <= 0) return 0;
  if (bw <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* pl = (const uint32_t*)planes;
  const auto* pa = (const uint32_t*)path;
  const auto* rl = (const int*)read_len;
  const auto* pn = (const int*)path_len;
  if (bw <= 32) {
    polish_core_any_kernel<1><<<R, 32, 0, st>>>(
        pl, pa, rl, pn, R, RW, P, bw, (uint32_t*)dvp, (uint32_t*)dvn,
        (int*)dsb, (int*)dbase);
  } else if (bw <= 64) {
    polish_core_any_kernel<2><<<R, 32, 0, st>>>(
        pl, pa, rl, pn, R, RW, P, bw, (uint32_t*)dvp, (uint32_t*)dvn,
        (int*)dsb, (int*)dbase);
  } else {
    const int threads = 32;
    polish_core_thread_kernel<<<(R + threads - 1) / threads, threads, 0,
                                st>>>(pl, pa, rl, pn, R, RW, P, bw,
                                      (uint32_t*)dvp, (uint32_t*)dvn,
                                      (int*)dsb, (int*)dbase);
  }
  return (int)cudaGetLastError();
}
