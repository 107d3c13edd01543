// Banded fragment-to-graph Myers DP, fresh windows (the CLC fragment stage).
//
// Replaces: graphchainer_tpu/ops/pallas_frag.py::frag_core_pallas (body
// _kernel), together with the gather in front of it.  Computes exactly
// graphchainer_torch/ops/frag_align.py lane_major + _frag_core_t (= the
// JAX _frag_core_t with carried, want_state and want_xcells off): per
// fragment, per 32-row slice, per topological level, every band slot of
// the level merges its candidate words (seed injection on slice 0,
// vertical carry on later slices, up to max_in in-band predecessors
// advanced one column) by exact elementwise min over 33 expanded row
// scores, then advances its remaining columns; the winning candidate of
// each slot and slice goes to best_in, the best end cell to best_score /
// best_slot / best_col.
//
// Inputs are fragment-major in their host types, as the band build makes
// them: band_nodes int32 (F, B), band_in int8 (F, B, max_in), band_level
// int8 (F, B), seed_shift int32 (F,), req uint32 bits (F, S, 4), rows int32
// (F,), and the resident node table node_eq (N2, 4) / node_len (N2,).  The
// kernel gathers each slot's Eq words and length itself and trims slot 0
// by the seed shift.
//
// What bounds it on the H100: neither bytes nor operations.  A batch of
// the main path (F ~ 10k, B = 8, S = 2) moves ~1.5 MB and does ~31 M
// integer operations, half a microsecond either way.  What is left is the
// dependent chain of each fragment: every column of a slot is one Myers
// step on the words of the column before (~8 dependent instructions), a
// slot has ~15 columns, and a fragment ~3 live slots per slice.  So the
// time is the longest chain in a warp, times the latency of an integer
// instruction, over the few warps each scheduler holds.
//
// Design, against that chain:
// - Two lanes per fragment run the slices as a wavefront: slice s of the
//   k-th slot (in level order) needs slice s - 1 of the same slot and
//   slice s of lower levels only, so lane 0 takes slices 0, 2, ... and
//   lane 1 slices 1, 3, ..., one step behind; each step ends with a block
//   barrier.  A fragment whose band has an in-edge that does not come from
//   a lower level (band_build never makes one) runs its slices on lane 0
//   alone, which needs no such order.
// - 16 fragments (one warp) per block, so a batch of 10k fragments gives
//   641 blocks and all 132 SMs work (8 fragments a block for bands wider
//   than 32 slots, which hold up to ~10 KB of shared memory a fragment).
// - No local memory: per-slot state lives in shared memory, slot-major
//   with the fragment as the fast index; the 33 row scores of a merge are
//   registers.  A fragment's inputs are loaded at once, by the whole
//   block, as independent coalesced loads, before the first slice.
// - Only candidates that can change an output are merged.  Every
//   candidate word has disjoint vp / vn bits, so its row scores move by
//   one a row and a merge of one word gives back that word: the 33-row
//   merge runs only where two or more words remain.  An invalid in-edge
//   or seed candidate is the word (ONES, 0, BIG) and an invalid vertical
//   carry (ONES, 0, BIG + 32); both lie on or above any valid word whose
//   bottom score is at most BIG - 64 on every row, so they join the merge
//   only where no such word exists, and the vertical one only without the
//   other (which lies below it).
// - best_in is staged per block in shared memory (IN_NONE where no slot
//   was processed) and stored once, as 16-byte pieces of the block's
//   contiguous run of (F, B, S).
// Within a level every slot reads its predecessors' end words as they were
// before the level: end words are kept per slice parity, and a slot reads
// a predecessor of a lower level from its own slice and any other from
// the slice before (the reference's masked commit).
//
// The carried entry (frag_core_carried_launch, frag_carried_kernel) runs
// GA mode's extension windows, which JAX keeps off its Pallas kernel and
// computes in XLA (frag_align._frag_core_t with carried / want_state /
// want_xcells):
// - seed trims per slot (F, B): a carried window keeps the seed node
//   trimmed wherever it lands;
// - a carried state (column-0 bottom score and bottom-row horizontal bits
//   per slot, from the window before): slice 0 then reads it as a later
//   slice reads the slice before (vertical candidate, hin from the
//   bottom scores, the carried bits for columns 1..31), with no seed
//   candidate and no length-0 seed word;
// - the last slice's state out (BIG / 0 / 0 for slots no level holds),
//   whose bits run through all 31 columns, past the slot's length too;
// - the best X cell, X = (row + 1) - 5 * score over every slot's end word
//   and row, by (X, then the lowest slice, slot, row): the reference's
//   strict-greater scan order.
// GA windows are few fragments (F ~ 2 a read of the batch, B = 48, S =
// 2), so the card is nearly idle and the time is each fragment's chain of
// wavefront steps.  What a step of that chain holds, and what it does not:
// - One block a fragment (128 threads), so each block waits on its own
//   fragment's steps only.  Two "main" warps run the slices as the fresh
//   entry's two lanes do (warp j takes slices j, j + 2, ...).
// - The next level reads a slot's end word (column slen - 1) and the next
//   slice its columns below slen only.  The columns past the slot's
//   length (the tail) feed only the state out and the same slot's tail on
//   the next slice: the main warp keeps the word after its last column,
//   and after the wavefront a thread a slot runs that slot's tails slice
//   by slice, all slots side by side.  The X scan feeds only the X
//   outputs: two "aux" warps take it one step later, beside the main
//   warps' next step (the main warp hands over the end word).
// - Column 0's merge without a row loop: a lane a row, each candidate's
//   row score from two masked popcounts and a min, repacked by two
//   ballots; the X scan likewise, a lane a row, __reduce_max_sync and the
//   first lane at the max by ballot.  Only the columns 1 .. slen - 1 stay
//   a serial chain.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, kernel_turns.py), GA
// windows of the bench workload at B=48: 0.034 ms, against 0.099 ms for
// the earlier design (a template flag of the fresh kernel, two lanes a
// fragment, the tail columns and 32-row loops on the chain).
// Its outputs share the fresh entry's buffer, so one copy brings them home.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr int BIG = 1 << 28;
constexpr int REAL_MAX = BIG - 2 * W;   // see the note on merging
constexpr int IN_NONE = -1;
constexpr int IN_SEED = -2;
constexpr int IN_VERT = -3;
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// One Myers column step (ops/myers.advance_word); returns hout.
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

// The same step with the boundary delta as its two bits (hpos, hneg, not
// both set); the bottom row's delta comes back as the same two bits.
// With vp & vn = 0, which every word of the DP keeps, ph and mh are
// disjoint, so hout = hpo - hno.
__device__ __forceinline__ void column_step(uint32_t& vp, uint32_t& vn, uint32_t eq,
                                     uint32_t hpos, uint32_t hneg,
                                     uint32_t& hpo, uint32_t& hno) {
  eq |= hneg;
  const uint32_t xv = eq | vn;
  const uint32_t xh = (((eq & vp) + vp) ^ vp) | eq;
  uint32_t ph = vn | ~(xh | vp);
  uint32_t mh = vp & xh;
  hpo = ph >> 31;
  hno = mh >> 31;
  ph = (ph << 1) | hpos;
  mh = (mh << 1) | hneg;
  vp = mh | ~(xv | ph);
  vn = ph & xv;
}

// Fold a candidate word into the 33 expanded row scores.
__device__ __forceinline__ void acc_add(int& before, int (&rows)[W],
                                        uint32_t vp, uint32_t vn, int sb) {
  int s = sb - __popc(vp) + __popc(vn);
  before = min(before, s);
#pragma unroll
  for (int r = 0; r < W; ++r) {
    s += (int)((vp >> r) & 1u) - (int)((vn >> r) & 1u);
    rows[r] = min(rows[r], s);
  }
}

// The merge of a slot's candidate words: the first word is held as it is;
// the row scores are built from the second word on.
struct Merge {
  int n = 0;
  uint32_t vp = 0, vn = 0;
  int sb = 0;
  int before = BIG;
  int rows[W];

  __device__ __forceinline__ Merge() {
#pragma unroll
    for (int r = 0; r < W; ++r) rows[r] = BIG;
  }
  __device__ __forceinline__ void add(uint32_t wvp, uint32_t wvn, int wsb) {
    if (n == 0) {
      vp = wvp; vn = wvn; sb = wsb;
    } else {
      if (n == 1) acc_add(before, rows, vp, vn, sb);
      acc_add(before, rows, wvp, wvn, wsb);
    }
    ++n;
  }
  // repack: bits only where adjacent row scores differ by +-1
  __device__ __forceinline__ void result(uint32_t& cvp, uint32_t& cvn,
                                         int& csb) const {
    if (n == 1) { cvp = vp; cvn = vn; csb = sb; return; }
    cvp = 0; cvn = 0;
    int prev = before;
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const int d = rows[r] - prev;
      cvp |= (d == 1 ? 1u : 0u) << r;
      cvn |= (d == -1 ? 1u : 0u) << r;
      prev = rows[r];
    }
    csb = rows[W - 1];
  }
};

__device__ __forceinline__ int score_masked(uint32_t vp, uint32_t vn, int sb,
                                            uint32_t m) {
  return sb - __popc(vp & m) + __popc(vn & m);
}

// Shared memory of a block of FPB fragments: per-slot arrays are
// [.., slot, fragment] with the fragment fastest.
struct Smem {
  int4* rq;          // [FPB][S] read row planes
  uint32_t* seq;     // [4][B][FPB] slot Eq words (seed-trimmed)
  int* slen;         // [B][FPB] slot lengths (seed-trimmed)
  int* lvl;          // [B][FPB] levels
  uint32_t* evp;     // [2][B][FPB] end words by slice parity
  uint32_t* evn;
  int* esb;
  int* ssb;          // [B][FPB] previous slice: column-0 bottom score
  uint32_t* hp;      //   and bottom-row horizontal deltas
  uint32_t* hn;
  int* nsteps;       // [FPB] wavefront steps of each fragment
  int* kcount;       // [FPB] processed slots
  int* serial;       // [FPB] 1: lane 0 runs every slice
  uint8_t* order;    // [B][FPB] processed slots sorted by level
  int8_t* bin;       // [FPB][B][max_in] in-edges, as in device memory
  int8_t* stage;     // best_in of the block's fragments, [FPB][B][S]
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets of the Smem arrays; returns the total.
__host__ __device__ inline size_t smem_layout(int FPB, int B, int S,
                                              int max_in, size_t* off) {
  const size_t n = (size_t)B * FPB;
  size_t o = 0;
  off[0] = o; o += (size_t)FPB * S * 16;          // rq
  off[1] = o; o += 4 * n * 4;                     // seq
  off[2] = o; o += n * 4;                         // slen
  off[3] = o; o += n * 4;                         // lvl
  off[4] = o; o += 2 * n * 4;                     // evp
  off[5] = o; o += 2 * n * 4;                     // evn
  off[6] = o; o += 2 * n * 4;                     // esb
  off[7] = o; o += n * 4;                         // ssb
  off[8] = o; o += n * 4;                         // hp
  off[9] = o; o += n * 4;                         // hn
  off[10] = o; o += (size_t)FPB * 4;              // nsteps
  off[11] = o; o += (size_t)FPB * 4;              // kcount
  off[12] = o; o += (size_t)FPB * 4;              // serial
  off[13] = o; o += n;                            // order
  o = align16(o);
  off[14] = o; o += n * max_in;                   // bin
  o = align16(o);
  off[15] = o; o += n * S + 16;                   // stage (+ alignment)
  return align16(o);
}

// The carried entry's extra arguments: seed_shift per slot (F, B) when
// per_slot, else (F,) for slot 0;
// a carried state (F, B) each, or null for a fresh window; the last
// slice's state out (F, B) each, and the best X cell (F,) each, or null.
struct Ext {
  const int* carry_ssb;
  const uint32_t* carry_hp;
  const uint32_t* carry_hn;
  int per_slot;
  int* out_ssb;
  uint32_t* out_hp;
  uint32_t* out_hn;
  int* xbest;
  int* xslot;
  int* xrow;
};

template <int FPB>
__global__ void __launch_bounds__(2 * FPB)
frag_core_kernel(const int4* __restrict__ node_eq,        // (N2, 4)
                 const int* __restrict__ node_len,        // (N2,)
                 const int* __restrict__ band_nodes,      // (F, B)
                 const int8_t* __restrict__ band_in,      // (F, B, max_in)
                 const int8_t* __restrict__ band_level,   // (F, B)
                 const int* __restrict__ seed_shift,      // (F,) or (F, B)
                 const int4* __restrict__ req,            // (F, S, 4)
                 const int* __restrict__ rows,            // (F,)
                 int N2, int F, int B, int S, int max_in, int n_levels,
                 int* __restrict__ best_score, int* __restrict__ best_slot,
                 int* __restrict__ best_col,
                 int8_t* __restrict__ best_in) {          // (F, B, S)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t off[16];
  smem_layout(FPB, B, S, max_in, off);
  Smem sm;
  sm.rq = (int4*)(smem_raw + off[0]);
  sm.seq = (uint32_t*)(smem_raw + off[1]);
  sm.slen = (int*)(smem_raw + off[2]);
  sm.lvl = (int*)(smem_raw + off[3]);
  sm.evp = (uint32_t*)(smem_raw + off[4]);
  sm.evn = (uint32_t*)(smem_raw + off[5]);
  sm.esb = (int*)(smem_raw + off[6]);
  sm.ssb = (int*)(smem_raw + off[7]);
  sm.hp = (uint32_t*)(smem_raw + off[8]);
  sm.hn = (uint32_t*)(smem_raw + off[9]);
  sm.nsteps = (int*)(smem_raw + off[10]);
  sm.kcount = (int*)(smem_raw + off[11]);
  sm.serial = (int*)(smem_raw + off[12]);
  sm.order = (uint8_t*)(smem_raw + off[13]);
  sm.bin = (int8_t*)(smem_raw + off[14]);

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int fl = t >> 1;                 // fragment of the block
  const int j = t & 1;                   // lane of the fragment
  const int f0 = blockIdx.x * FPB;
  const int nf = min(FPB, F - f0);
  const int f = f0 + fl;
  const bool live = fl < nf;
  const int n = B * FPB;

  // best_in's run of this block, and its staging copy with the same
  // alignment mod 16
  int8_t* const gout = best_in + (size_t)f0 * B * S;
  const int run = nf * B * S;
  const int mis = (int)((uintptr_t)gout & 15u);
  sm.stage = (int8_t*)(smem_raw + off[15]) + mis;

  // ---- the block's inputs, all at once: its fragments own one
  // contiguous run of every array
  const int nslot = nf * B;
#pragma unroll 4
  for (int i = t; i < nslot; i += nt) {
    const int q = i / B, b = i - q * B;
    const int id = band_nodes[(size_t)f0 * B + i];
    const int idc = min(max(id, 0), N2 - 1);
    const int4 e = node_eq[idc];
    int len = id >= 0 ? node_len[idc] : 0;
    uint32_t sh = 0;
    if (b == 0) {
      const int ss = seed_shift[f0 + q];
      sh = (uint32_t)ss & 31u;
      len -= ss;
    }
    const int o = b * FPB + q;
    sm.seq[o] = (uint32_t)e.x >> sh;
    sm.seq[n + o] = (uint32_t)e.y >> sh;
    sm.seq[2 * n + o] = (uint32_t)e.z >> sh;
    sm.seq[3 * n + o] = (uint32_t)e.w >> sh;
    sm.slen[o] = len;
    sm.lvl[o] = band_level[(size_t)f0 * B + i];
  }
  const int8_t* gin = band_in + (size_t)f0 * B * max_in;
  const int nbin = nslot * max_in;
  if ((((uintptr_t)gin) & 3u) == 0 && (nbin & 3) == 0) {
#pragma unroll 4
    for (int i = t; i < (nbin >> 2); i += nt)
      reinterpret_cast<int*>(sm.bin)[i] = reinterpret_cast<const int*>(gin)[i];
  } else {
#pragma unroll 4
    for (int i = t; i < nbin; i += nt) sm.bin[i] = gin[i];
  }
  for (int i = t; i < nf * S; i += nt) sm.rq[i] = req[(size_t)f0 * S + i];
  for (int i = t; i < FPB; i += nt) sm.serial[i] = 0;
  for (int i = t; i < n; i += nt) {
    sm.evp[i] = 0; sm.evp[n + i] = 0;
    sm.evn[i] = 0; sm.evn[n + i] = 0;
    sm.esb[i] = BIG; sm.esb[n + i] = BIG;
    sm.ssb[i] = BIG; sm.hp[i] = 0; sm.hn[i] = 0;
  }
  for (int i = t; i < run; i += nt) sm.stage[i] = (int8_t)IN_NONE;
  __syncthreads();

  // ---- per fragment, lane 0 sorts the processed slots by level (stable);
  // the block checks that every in-edge comes from a lower level
  if (live && j == 0) {
    int k = 0;
    for (int b = 0; b < B; ++b) {
      const int l = sm.lvl[b * FPB + fl];
      if (l < 0 || l >= n_levels) continue;
      int q = k++;
      while (q > 0 && sm.lvl[sm.order[(q - 1) * FPB + fl] * FPB + fl] > l) {
        sm.order[q * FPB + fl] = sm.order[(q - 1) * FPB + fl];
        --q;
      }
      sm.order[q * FPB + fl] = (uint8_t)b;
    }
    sm.kcount[fl] = k;
  }
  for (int i = t; i < nslot; i += nt) {
    const int q = i / B, b = i - q * B;
    const int l = sm.lvl[b * FPB + q];
    if (l < 0 || l >= n_levels) continue;
    for (int e = 0; e < max_in; ++e) {
      const int u = sm.bin[i * max_in + e];
      if (u < 0 || u >= B) continue;
      const int lu = sm.lvl[u * FPB + q];
      if (lu >= 0 && lu < n_levels && lu >= l) sm.serial[q] = 1;
    }
  }
  __syncthreads();

  int K = 0, ser = 0;
  if (live) { K = sm.kcount[fl]; ser = sm.serial[fl]; }
  // slice s starts at step (s / 2) * P + s % 2 on the wavefront
  const int P = ser ? K : max(K, 2);
  if (live && j == 0)
    sm.nsteps[fl] = K == 0 ? 0
                  : ser    ? S * K
                           : ((S - 1) >> 1) * P + ((S - 1) & 1) + K;
  __syncthreads();
  int T = 0;
  for (int q = 0; q < nf; ++q) T = max(T, sm.nsteps[q]);

  int fb_sc = BIG, fb_slot = 0, fb_col = 0;   // this lane's best end cell
  const int fl_rows = live ? rows[f] : 1;
  const int end_slice = floordiv(fl_rows - 1, W);
  const int er = (fl_rows - 1) - end_slice * W;         // floor mod, 0..31
  const uint32_t erm = er < W - 1 ? (ONES << (er + 1)) : 0u;
  const int b0_sb = W;                                  // source_word(0)

  int s = (!live || (ser && j == 1)) ? S : j;   // this lane's slice
  int kk = ser ? 0 : -j;                        // its position in it
  const int sstep = ser ? 1 : 2;

  for (int step = 0; step < T; ++step) {
    if (s < S && kk >= 0 && kk < K) {
      const int b = sm.order[kk * FPB + fl];
      const int ib = b * FPB + fl;
      const int cur = s & 1;
      const int lv = sm.lvl[ib];
      const int slen = sm.slen[ib];
      const bool active = slen > 0;
      const uint32_t sq0 = sm.seq[ib], sq1 = sm.seq[n + ib];
      const uint32_t sq2 = sm.seq[2 * n + ib], sq3 = sm.seq[3 * n + ib];
      const int4 rv = sm.rq[fl * S + s];
      const uint32_t r0 = (uint32_t)rv.x, r1 = (uint32_t)rv.y;
      const uint32_t r2 = (uint32_t)rv.z, r3 = (uint32_t)rv.w;
      const bool at_end = end_slice == s;
      const bool prev = s > 0;               // the slice before exists
      int pssb = BIG;
      uint32_t php = 0, phn = 0;
      if (prev) { pssb = sm.ssb[ib]; php = sm.hp[ib]; phn = sm.hn[ib]; }
      const uint32_t eq0 = ((sq0 & 1u) ? r0 : 0u) | ((sq1 & 1u) ? r1 : 0u)
                         | ((sq2 & 1u) ? r2 : 0u) | ((sq3 & 1u) ? r3 : 0u);

      Merge mg;
      bool real = false, inv = false, vinv = false;
      int cbest = IN_NONE;
      int csb_run = BIG;
      if (!prev) {
        if (b == 0) {   // seed injection: the boundary word, one column on
          uint32_t avp = ONES, avn = 0;
          int asb = b0_sb;
          advance(avp, avn, asb, eq0, 1);
          mg.add(avp, avn, asb);
          real |= asb <= REAL_MAX;
          if (asb < csb_run) cbest = IN_SEED;
          csb_run = min(csb_run, asb);
        } else {
          inv = true;
        }
      } else if (active && pssb < BIG) {   // vertical carry
        const int vsb = pssb + W;
        mg.add(ONES, 0u, vsb);
        real |= vsb <= REAL_MAX;
        if (vsb < csb_run) cbest = IN_VERT;
        csb_run = min(csb_run, vsb);
      } else {
        vinv = true;
      }
      for (int e = 0; e < max_in; ++e) {
        const int u = sm.bin[(fl * B + b) * max_in + e];
        if (u < 0 || !active) { inv = true; continue; }
        uint32_t uvp = 0, uvn = 0;
        int usb = BIG;
        if (u < B) {
          const int ub = sm.lvl[u * FPB + fl] < lv ? cur : cur ^ 1;
          const int iu = ub * n + u * FPB + fl;
          uvp = sm.evp[iu]; uvn = sm.evn[iu]; usb = sm.esb[iu];
        }
        if (usb >= BIG) { inv = true; continue; }
        int hin = 1;
        if (prev && pssb < BIG) {
          const int ubs = usb - __popc(uvp) + __popc(uvn);
          hin = max(-1, min(1, pssb - ubs));
        }
        advance(uvp, uvn, usb, eq0, hin);
        mg.add(uvp, uvn, usb);
        real |= usb <= REAL_MAX;
        if (usb < csb_run) cbest = u;
        csb_run = min(csb_run, usb);
      }
      if (!real) {
        if (inv) mg.add(ONES, 0u, BIG);
        else if (vinv) mg.add(ONES, 0u, BIG + W);
      }
      uint32_t cvp, cvn;
      int csb;
      mg.result(cvp, cvn, csb);
      if (!prev && b == 0 && slen == 0) {   // len-0 seed slot
        cvp = ONES; cvn = 0; csb = b0_sb; cbest = IN_SEED;
      }
      const int col0_sb = csb;

      int best_sc = (at_end && active) ? score_masked(cvp, cvn, csb, erm)
                                       : BIG;
      int best_cl = 0;
      uint32_t wvp = cvp, wvn = cvn;
      int wsb = csb;
      uint32_t hp_acc = 0, hn_acc = 0;
      // columns past the slot's length reach no output
      const int ncol = min(slen, W);
      // the end word: column slen - 1 (none past the 32nd column)
      uint32_t evp_c = 0, evn_c = 0;
      int esb_c = BIG;
      // slice 0 enters every column with +1 from above
      const uint32_t hpin = prev ? php : ONES;
      const uint32_t hnin = prev ? phn : 0u;
      for (int c = 1; c < ncol; ++c) {
        const uint32_t eqc = (((sq0 >> c) & 1u) ? r0 : 0u)
                           | (((sq1 >> c) & 1u) ? r1 : 0u)
                           | (((sq2 >> c) & 1u) ? r2 : 0u)
                           | (((sq3 >> c) & 1u) ? r3 : 0u);
        uint32_t hpo, hno;
        column_step(wvp, wvn, eqc, (hpin >> c) & 1u, (hnin >> c) & 1u, hpo, hno);
        wsb += (int)hpo - (int)hno;
        hp_acc |= hpo << c;
        hn_acc |= hno << c;
        if (at_end) {
          const int sr = score_masked(wvp, wvn, wsb, erm);
          if (sr < best_sc) { best_sc = sr; best_cl = c; }
        }
      }
      if (slen <= W) { evp_c = wvp; evn_c = wvn; esb_c = wsb; }
      if (!(active || (b == 0 && slen == 0))) esb_c = BIG;
      const int ie = cur * n + ib;
      sm.evp[ie] = evp_c; sm.evn[ie] = evn_c; sm.esb[ie] = esb_c;
      sm.ssb[ib] = col0_sb; sm.hp[ib] = hp_acc; sm.hn[ib] = hn_acc;
      sm.stage[(fl * B + b) * S + s] = (int8_t)cbest;
      // lowest score, then lowest slot (the reference's strict < over b)
      if (best_sc < BIG
          && (best_sc < fb_sc || (best_sc == fb_sc && b < fb_slot))) {
        fb_sc = best_sc; fb_slot = b; fb_col = best_cl;
      }
    }
    if (++kk == P) { kk = 0; s += sstep; }
    __syncthreads();
  }

  // ---- outputs: the two lanes' best end cells, then best_in in one pass
  const unsigned mask = nt == 32 ? 0xFFFFFFFFu : ((1u << nt) - 1u);
  const int o_sc = __shfl_xor_sync(mask, fb_sc, 1);
  const int o_slot = __shfl_xor_sync(mask, fb_slot, 1);
  const int o_col = __shfl_xor_sync(mask, fb_col, 1);
  if (live && j == 0) {
    if (o_sc < fb_sc || (o_sc == fb_sc && o_slot < fb_slot)) {
      fb_sc = o_sc; fb_slot = o_slot; fb_col = o_col;
    }
    best_score[f] = fb_sc;
    best_slot[f] = fb_slot;
    best_col[f] = fb_col;
  }
  const int head = min(run, (16 - mis) & 15);
  const int body = (run - head) >> 4;
  for (int i = t; i < head; i += nt) gout[i] = sm.stage[i];
  for (int i = t; i < body; i += nt)
    reinterpret_cast<int4*>(gout + head)[i] =
        reinterpret_cast<const int4*>(sm.stage + head)[i];
  for (int i = head + (body << 4) + t; i < run; i += nt) gout[i] = sm.stage[i];
}

template <int FPB>
cudaError_t launch(const int4* node_eq, const int* node_len,
                   const int* band_nodes, const int8_t* band_in,
                   const int8_t* band_level, const int* seed_shift,
                   const int4* req, const int* rows, int N2, int F, int B,
                   int S, int max_in, int n_levels, int* best_score,
                   int* best_slot, int* best_col, int8_t* best_in,
                   cudaStream_t stream) {
  size_t off[16];
  const size_t bytes = smem_layout(FPB, B, S, max_in, off);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frag_core_kernel<FPB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (F + FPB - 1) / FPB;
  frag_core_kernel<FPB><<<blocks, 2 * FPB, bytes, stream>>>(
      node_eq, node_len, band_nodes, band_in, band_level, seed_shift, req,
      rows, N2, F, B, S, max_in, n_levels, best_score, best_slot, best_col,
      best_in);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The carried entry: one block a fragment, four warps.  Warps 0 and 1
// ("main") run the slices as the fresh entry's two lanes do (warp j takes
// slices j, j + 2, ..., one step behind warp j - 1; or warp 0 alone when
// an in-edge does not come from a lower level); warps 2 and 3 ("aux")
// take, one step later, the X-cell scan of the slot that main warp j - 2
// just ran.  The tail columns run after the wavefront.
struct Hand {            // what a main warp hands to its aux warp
  int valid, b, s, active;
  uint32_t evp, evn;     // the slot's end word
  int esb, pad;
};

// Byte offsets of the carried kernel's shared memory; returns the total.
__host__ __device__ inline size_t carried_layout(int B, int S, int max_in,
                                                 size_t* off) {
  const size_t b4 = (size_t)B * 4;
  size_t o = 0;
  off[0] = o; o += (size_t)S * 16;                // rq
  off[1] = o; o += 4 * b4;                        // seq
  off[2] = o; o += b4;                            // slen
  off[3] = o; o += b4;                            // lvl
  off[4] = o; o += 2 * b4;                        // evp [2][B]
  off[5] = o; o += 2 * b4;                        // evn
  off[6] = o; o += 2 * b4;                        // esb
  off[7] = o; o += b4;                            // ssb
  off[8] = o; o += b4;                            // hp
  off[9] = o; o += b4;                            // hn
  off[10] = o; o += b4 * S;                       // tvp [B][S]
  off[11] = o; o += b4 * S;                       // tvn
  o = align16(o);
  off[12] = o; o += 4 * sizeof(Hand);             // hand [2][2]
  off[13] = o; o += 16 * 4;                       // misc ints
  off[14] = o; o += B;                            // order
  off[15] = o; o += (size_t)B * max_in;           // bin
  off[16] = o; o += (size_t)B * S;                // stage
  return align16(o);
}

__global__ void __launch_bounds__(128)
frag_carried_kernel(const int4* __restrict__ node_eq,        // (N2, 4)
                    const int* __restrict__ node_len,        // (N2,)
                    const int* __restrict__ band_nodes,      // (F, B)
                    const int8_t* __restrict__ band_in,      // (F, B, max_in)
                    const int8_t* __restrict__ band_level,   // (F, B)
                    const int* __restrict__ seed_shift,      // (F,) / (F, B)
                    const int4* __restrict__ req,            // (F, S, 4)
                    const int* __restrict__ rows,            // (F,)
                    int N2, int B, int S, int max_in, int n_levels,
                    int* __restrict__ best_score, int* __restrict__ best_slot,
                    int* __restrict__ best_col,
                    int8_t* __restrict__ best_in,            // (F, B, S)
                    const Ext ext) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t off[17];
  carried_layout(B, S, max_in, off);
  int4* rq = (int4*)(smem_raw + off[0]);
  uint32_t* seq = (uint32_t*)(smem_raw + off[1]);
  int* slens = (int*)(smem_raw + off[2]);
  int* lvl = (int*)(smem_raw + off[3]);
  uint32_t* evp = (uint32_t*)(smem_raw + off[4]);
  uint32_t* evn = (uint32_t*)(smem_raw + off[5]);
  int* esb = (int*)(smem_raw + off[6]);
  int* ssb = (int*)(smem_raw + off[7]);
  uint32_t* hp = (uint32_t*)(smem_raw + off[8]);
  uint32_t* hn = (uint32_t*)(smem_raw + off[9]);
  uint32_t* tvp = (uint32_t*)(smem_raw + off[10]);
  uint32_t* tvn = (uint32_t*)(smem_raw + off[11]);
  Hand* hand = (Hand*)(smem_raw + off[12]);
  int* misc = (int*)(smem_raw + off[13]);
  uint8_t* order = (uint8_t*)(smem_raw + off[14]);
  int8_t* bin = (int8_t*)(smem_raw + off[15]);
  int8_t* stage = (int8_t*)(smem_raw + off[16]);

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int f = blockIdx.x;
  const bool carried = ext.carry_ssb != nullptr;
  const bool want_state = ext.out_ssb != nullptr;
  const bool want_x = ext.xbest != nullptr;

  // ---- the fragment's inputs
  for (int b = t; b < B; b += 128) {
    const size_t g = (size_t)f * B + b;
    const int id = band_nodes[g];
    const int idc = min(max(id, 0), N2 - 1);
    const int4 e = node_eq[idc];
    int len = id >= 0 ? node_len[idc] : 0;
    uint32_t sh = 0;
    if (ext.per_slot || b == 0) {
      const int ss = ext.per_slot ? seed_shift[g] : seed_shift[f];
      sh = (uint32_t)ss & 31u;
      len -= ss;
    }
    seq[b] = (uint32_t)e.x >> sh;
    seq[B + b] = (uint32_t)e.y >> sh;
    seq[2 * B + b] = (uint32_t)e.z >> sh;
    seq[3 * B + b] = (uint32_t)e.w >> sh;
    slens[b] = len;
    lvl[b] = band_level[g];
    evp[b] = 0; evp[B + b] = 0;
    evn[b] = 0; evn[B + b] = 0;
    esb[b] = BIG; esb[B + b] = BIG;
    // slice 0 continues the carried state, or enters every column with +1
    ssb[b] = carried ? ext.carry_ssb[g] : BIG;
    hp[b] = carried ? ext.carry_hp[g] : 0u;
    hn[b] = carried ? ext.carry_hn[g] : 0u;
  }
  const int8_t* gin = band_in + (size_t)f * B * max_in;
  for (int i = t; i < B * max_in; i += 128) bin[i] = gin[i];
  for (int i = t; i < S; i += 128) rq[i] = req[(size_t)f * S + i];
  for (int i = t; i < B * S; i += 128) stage[i] = (int8_t)IN_NONE;
  if (t < 4) hand[t].valid = 0;
  if (t == 0) misc[0] = 0;
  __syncthreads();

  // ---- the processed slots in level order (stable: by level, then
  // slot), each thread ranking its own slot (B <= 128 threads); and
  // whether every in-edge comes from a lower level
  bool mine = false;
  if (t < B) {
    const int l = lvl[t];
    if (l >= 0 && l < n_levels) {
      mine = true;
      int pos = 0;
      for (int q = 0; q < B; ++q) {
        const int lq = lvl[q];
        pos += (lq >= 0 && lq < n_levels && (lq < l || (lq == l && q < t)))
                   ? 1 : 0;
      }
      order[pos] = (uint8_t)t;
      for (int e = 0; e < max_in; ++e) {
        const int u = bin[t * max_in + e];
        if (u < 0 || u >= B) continue;
        const int lu = lvl[u];
        if (lu >= 0 && lu < n_levels && lu >= l) misc[0] = 1;
      }
    }
  }
  const int K = __syncthreads_count(mine);
  const int ser = misc[0];
  // slice s starts at step (s / 2) * P + s % 2 on the wavefront; one
  // step more for the aux warps
  const int P = ser ? K : max(K, 2);
  const int T = K == 0 ? 0
              : 1 + (ser ? S * K : ((S - 1) >> 1) * P + ((S - 1) & 1) + K);

  const int fl_rows = rows[f];
  const int end_slice = floordiv(fl_rows - 1, W);
  const int er = (fl_rows - 1) - end_slice * W;         // floor mod, 0..31
  const uint32_t erm = er < W - 1 ? (ONES << (er + 1)) : 0u;
  const int b0_sb = W;                                  // source_word(0)
  const uint32_t low = lane == W - 1 ? ONES : ((2u << lane) - 1u);  // rows
                                                        // 0..lane
  const int j = warp & 1;                  // the slice parity of the warp
  const bool main_warp = warp < 2;
  int s = (ser && j == 1) ? S : j;         // the main warp's slice
  int kk = ser ? 0 : -j;                   // its position in it
  const int sstep = ser ? 1 : 2;
  int fb_sc = BIG, fb_slot = 0, fb_col = 0;   // main: best end cell
  // aux: the best X cell, the highest X, then the lowest (slice, slot,
  // row); X <= -BIG never counts
  int xb = -BIG, xs = 0, xsl = 0, xr = 0;

  for (int step = 0; step < T; ++step) {
    if (main_warp) {
      Hand h;
      h.valid = 0;
      if (s < S && kk >= 0 && kk < K) {
        const int b = order[kk];
        const int cur = s & 1;
        const int lv = lvl[b];
        const int slen = slens[b];
        const bool active = slen > 0;
        const uint32_t sq0 = seq[b], sq1 = seq[B + b];
        const uint32_t sq2 = seq[2 * B + b], sq3 = seq[3 * B + b];
        const int4 rv = rq[s];
        const uint32_t r0 = (uint32_t)rv.x, r1 = (uint32_t)rv.y;
        const uint32_t r2 = (uint32_t)rv.z, r3 = (uint32_t)rv.w;
        const bool at_end = end_slice == s;
        // the state of the slice before (or the carried one) exists
        const bool prev = s > 0 || carried;
        int pssb = BIG;
        uint32_t php = 0, phn = 0;
        if (prev) { pssb = ssb[b]; php = hp[b]; phn = hn[b]; }
        const uint32_t eq0 = ((sq0 & 1u) ? r0 : 0u) | ((sq1 & 1u) ? r1 : 0u)
                           | ((sq2 & 1u) ? r2 : 0u) | ((sq3 & 1u) ? r3 : 0u);

        // column 0: the candidates' row scores, a lane a row (row = lane);
        // the first word is held as it is, the merge of two or more is
        // the min of the row scores, repacked by ballots
        int n_c = 0;
        uint32_t fvp = 0, fvn = 0;
        int fsb = 0;
        int rmin = BIG, bmin = BIG;
        auto add = [&](uint32_t vp, uint32_t vn, int sb) {
          if (n_c == 0) { fvp = vp; fvn = vn; fsb = sb; }
          const int bef = sb - __popc(vp) + __popc(vn);
          bmin = min(bmin, bef);
          rmin = min(rmin, bef + __popc(vp & low) - __popc(vn & low));
          ++n_c;
        };
        bool real = false, inv = false, vinv = false;
        int cbest = IN_NONE;
        int csb_run = BIG;
        if (!prev) {
          if (b == 0) {   // seed injection: the boundary word, one column on
            uint32_t avp = ONES, avn = 0;
            int asb = b0_sb;
            advance(avp, avn, asb, eq0, 1);
            add(avp, avn, asb);
            real |= asb <= REAL_MAX;
            if (asb < csb_run) cbest = IN_SEED;
            csb_run = min(csb_run, asb);
          } else {
            inv = true;
          }
        } else if (active && pssb < BIG) {   // vertical carry
          const int vsb = pssb + W;
          add(ONES, 0u, vsb);
          real |= vsb <= REAL_MAX;
          if (vsb < csb_run) cbest = IN_VERT;
          csb_run = min(csb_run, vsb);
        } else {
          vinv = true;
        }
        for (int e = 0; e < max_in; ++e) {
          const int u = bin[b * max_in + e];
          if (u < 0 || !active) { inv = true; continue; }
          uint32_t uvp = 0, uvn = 0;
          int usb = BIG;
          if (u < B) {
            const int iu = (lvl[u] < lv ? cur : cur ^ 1) * B + u;
            uvp = evp[iu]; uvn = evn[iu]; usb = esb[iu];
          }
          if (usb >= BIG) { inv = true; continue; }
          int hin = 1;
          if (prev && pssb < BIG) {
            const int ubs = usb - __popc(uvp) + __popc(uvn);
            hin = max(-1, min(1, pssb - ubs));
          }
          advance(uvp, uvn, usb, eq0, hin);
          add(uvp, uvn, usb);
          real |= usb <= REAL_MAX;
          if (usb < csb_run) cbest = u;
          csb_run = min(csb_run, usb);
        }
        if (!real) {
          if (inv) add(ONES, 0u, BIG);
          else if (vinv) add(ONES, 0u, BIG + W);
        }
        uint32_t cvp, cvn;
        int csb;
        if (n_c == 1) {
          cvp = fvp; cvn = fvn; csb = fsb;
        } else {   // bits only where adjacent row scores differ by +-1
          const int up = __shfl_up_sync(FULL, rmin, 1);
          const int d = rmin - (lane == 0 ? bmin : up);
          cvp = __ballot_sync(FULL, d == 1);
          cvn = __ballot_sync(FULL, d == -1);
          csb = __shfl_sync(FULL, rmin, W - 1);
        }
        if (!prev && b == 0 && slen == 0) {   // len-0 seed slot
          cvp = ONES; cvn = 0; csb = b0_sb; cbest = IN_SEED;
        }
        const int col0_sb = csb;

        // columns 1 .. min(slen, 32) - 1; the ones past the slot's length
        // (the tail) feed only the state out and run after the wavefront
        int best_sc = (at_end && active) ? score_masked(cvp, cvn, csb, erm)
                                         : BIG;
        int best_cl = 0;
        uint32_t wvp = cvp, wvn = cvn;
        int wsb = csb;
        uint32_t hp_acc = 0, hn_acc = 0;
        const uint32_t hpin = prev ? php : ONES;
        const uint32_t hnin = prev ? phn : 0u;
        const int ncol = min(slen, W);
        for (int c = 1; c < ncol; ++c) {
          const uint32_t eqc = (((sq0 >> c) & 1u) ? r0 : 0u)
                             | (((sq1 >> c) & 1u) ? r1 : 0u)
                             | (((sq2 >> c) & 1u) ? r2 : 0u)
                             | (((sq3 >> c) & 1u) ? r3 : 0u);
          uint32_t hpo, hno;
          column_step(wvp, wvn, eqc, (hpin >> c) & 1u, (hnin >> c) & 1u,
                      hpo, hno);
          wsb += (int)hpo - (int)hno;
          hp_acc |= hpo << c;
          hn_acc |= hno << c;
          if (at_end) {
            const int sr = score_masked(wvp, wvn, wsb, erm);
            if (sr < best_sc) { best_sc = sr; best_cl = c; }
          }
        }
        // the end word: column slen - 1 (none past the 32nd column)
        uint32_t evp_c = 0, evn_c = 0;
        int esb_c = BIG;
        if (slen <= W) { evp_c = wvp; evn_c = wvn; esb_c = wsb; }
        if (!(active || (b == 0 && slen == 0))) esb_c = BIG;

        if (lane == 0) {
          const int ie = cur * B + b;
          evp[ie] = evp_c; evn[ie] = evn_c; esb[ie] = esb_c;
          ssb[b] = col0_sb; hp[b] = hp_acc; hn[b] = hn_acc;
          stage[b * S + s] = (int8_t)cbest;
          tvp[b * S + s] = wvp; tvn[b * S + s] = wvn;
        }
        // lowest score, then lowest slot (the reference's strict < over b)
        if (best_sc < BIG
            && (best_sc < fb_sc || (best_sc == fb_sc && b < fb_slot))) {
          fb_sc = best_sc; fb_slot = b; fb_col = best_cl;
        }
        h = Hand{1, b, s, active ? 1 : 0, evp_c, evn_c, esb_c, 0};
      }
      if (lane == 0) hand[(step & 1) * 2 + j] = h;
      if (++kk == P) { kk = 0; s += sstep; }
    } else if (step > 0) {
      const Hand h = hand[((step - 1) & 1) * 2 + j];
      if (h.valid) {
        const int b = h.b, hs = h.s;
        if (want_x && h.active && h.esb < BIG) {
          // X = (row + 1) - 5 * score over the end word's rows, a lane a
          // row: the first best row of the slot, then against the warp's
          // best so far
          const int bef = h.esb - __popc(h.evp) + __popc(h.evn);
          const int sr = bef + __popc(h.evp & low) - __popc(h.evn & low);
          const int nr = min(W, fl_rows - hs * W);
          const int x = lane < nr ? hs * W + lane + 1 - 5 * sr : INT_MIN;
          const int sv = __reduce_max_sync(FULL, x);
          const int srow = __ffs(__ballot_sync(FULL, x == sv)) - 1;
          if (sv > xb || (sv == xb && sv > -BIG
                          && (hs < xs || (hs == xs && b < xsl)))) {
            xb = sv; xs = hs; xsl = b; xr = srow;
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- outputs: the warps' bests (warp 1 and warp 3 hand theirs over),
  // the state out, best_in
  if (lane == 0 && warp == 1) {
    misc[1] = fb_sc; misc[2] = fb_slot; misc[3] = fb_col;
  }
  if (lane == 0 && warp == 3) {
    misc[4] = xb; misc[5] = xs; misc[6] = xsl; misc[7] = xr;
  }
  __syncthreads();
  if (t == 0) {
    const int o_sc = misc[1], o_slot = misc[2], o_col = misc[3];
    if (o_sc < fb_sc || (o_sc == fb_sc && o_slot < fb_slot)) {
      fb_sc = o_sc; fb_slot = o_slot; fb_col = o_col;
    }
    best_score[f] = fb_sc;
    best_slot[f] = fb_slot;
    best_col[f] = fb_col;
  }
  if (want_x && t == 64) {
    const int o_xb = misc[4], o_xs = misc[5], o_xsl = misc[6];
    if (o_xb > xb || (o_xb == xb && o_xb > -BIG
                      && (o_xs < xs || (o_xs == xs && o_xsl < xsl)))) {
      xb = o_xb; xs = o_xs; xsl = o_xsl; xr = misc[7];
    }
    ext.xbest[f] = xb;
    ext.xslot[f] = xsl;
    ext.xrow[f] = xb > -BIG ? xs * W + xr : 0;
  }
  if (want_state && t < B) {
    // the last slice's state of every slot it processed; BIG / 0 / 0 for
    // the others, as the reference's per-slice state starts.  The bits of
    // the columns past the slot's length (the tail) come here, a thread a
    // slot: slice by slice, columns max(slen, 1) .. 31 from the word after
    // the last main column, entered by the tail bits of the slice before
    // (the carried ones, or +1 for a fresh slice 0)
    const int b = t, l = lvl[b];
    const bool done = l >= 0 && l < n_levels;
    const size_t g = (size_t)f * B + b;
    uint32_t tp = carried ? ext.carry_hp[g] : ONES;
    uint32_t tn = carried ? ext.carry_hn[g] : 0u;
    if (done) {
      const int slen = slens[b];
      const uint32_t sq0 = seq[b], sq1 = seq[B + b];
      const uint32_t sq2 = seq[2 * B + b], sq3 = seq[3 * B + b];
      for (int ts = 0; ts < S; ++ts) {
        const int4 rv = rq[ts];
        const uint32_t r0 = (uint32_t)rv.x, r1 = (uint32_t)rv.y;
        const uint32_t r2 = (uint32_t)rv.z, r3 = (uint32_t)rv.w;
        uint32_t wvp = tvp[b * S + ts], wvn = tvn[b * S + ts];
        uint32_t np = 0, nn = 0;
        for (int c = max(slen, 1); c < W; ++c) {
          const uint32_t eqc = (((sq0 >> c) & 1u) ? r0 : 0u)
                             | (((sq1 >> c) & 1u) ? r1 : 0u)
                             | (((sq2 >> c) & 1u) ? r2 : 0u)
                             | (((sq3 >> c) & 1u) ? r3 : 0u);
          uint32_t hpo, hno;
          column_step(wvp, wvn, eqc, (tp >> c) & 1u, (tn >> c) & 1u, hpo,
                      hno);
          np |= hpo << c;
          nn |= hno << c;
        }
        tp = np;
        tn = nn;
      }
    }
    ext.out_ssb[g] = done ? ssb[b] : BIG;
    ext.out_hp[g] = done ? (hp[b] | tp) : 0u;
    ext.out_hn[g] = done ? (hn[b] | tn) : 0u;
  }
  int8_t* gout = best_in + (size_t)f * B * S;
  for (int i = t; i < B * S; i += 128) gout[i] = stage[i];
}

cudaError_t launch_carried(const int4* node_eq, const int* node_len,
                           const int* band_nodes, const int8_t* band_in,
                           const int8_t* band_level, const int* seed_shift,
                           const int4* req, const int* rows, int N2, int F,
                           int B, int S, int max_in, int n_levels,
                           int* best_score, int* best_slot, int* best_col,
                           int8_t* best_in, const Ext& ext,
                           cudaStream_t stream) {
  size_t off[17];
  const size_t bytes = carried_layout(B, S, max_in, off);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frag_carried_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  frag_carried_kernel<<<F, 128, bytes, stream>>>(
      node_eq, node_len, band_nodes, band_in, band_level, seed_shift, req,
      rows, N2, B, S, max_in, n_levels, best_score, best_slot, best_col,
      best_in, ext);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frag_core_launch(const void* node_eq, const void* node_len,
                                const void* band_nodes, const void* band_in,
                                const void* band_level,
                                const void* seed_shift, const void* req,
                                const void* rows, int N2, int F, int B, int S,
                                int max_in, int n_levels, void* best_score,
                                void* best_slot, void* best_col,
                                void* best_in, void* stream) {
  if (F <= 0) return 0;
  if (B < 1 || B > 128 || S < 1 || max_in < 0 || N2 < 1)
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto launcher) {
    return launcher((const int4*)node_eq, (const int*)node_len,
                    (const int*)band_nodes, (const int8_t*)band_in,
                    (const int8_t*)band_level, (const int*)seed_shift,
                    (const int4*)req, (const int*)rows, N2, F, B, S, max_in,
                    n_levels, (int*)best_score, (int*)best_slot,
                    (int*)best_col, (int8_t*)best_in, (cudaStream_t)stream);
  };
  // wide bands (escalation, dense graphs) hold up to ~10 KB a fragment
  const cudaError_t err = B <= 32 ? args(launch<16>) : args(launch<8>);
  return (int)err;
}

// The carried entry (GA mode's windows): seed_shift (F, B) when per_slot,
// else (F,); carry_* null for a fresh window; out_* and x* null when not
// wanted.  Output pointers in the order of ops/frag_align.FragResult.
extern "C" int frag_core_carried_launch(
    const void* node_eq, const void* node_len, const void* band_nodes,
    const void* band_in, const void* band_level, const void* seed_shift,
    const void* req, const void* rows, const void* carry_ssb,
    const void* carry_hp, const void* carry_hn, int N2, int F, int B, int S,
    int max_in, int n_levels, int per_slot, void* best_score,
    void* best_slot, void* best_col, void* best_in, void* out_ssb,
    void* out_hp, void* out_hn, void* xbest, void* xslot, void* xrow,
    void* stream) {
  if (F <= 0) return 0;
  if (B < 1 || B > 128 || S < 1 || max_in < 0 || N2 < 1)
    return (int)cudaErrorInvalidValue;
  if ((carry_ssb == nullptr) != (carry_hp == nullptr)
      || (carry_ssb == nullptr) != (carry_hn == nullptr)
      || (out_ssb == nullptr) != (out_hp == nullptr)
      || (out_ssb == nullptr) != (out_hn == nullptr)
      || (xbest == nullptr) != (xslot == nullptr)
      || (xbest == nullptr) != (xrow == nullptr))
    return (int)cudaErrorInvalidValue;
  const Ext ext{(const int*)carry_ssb, (const uint32_t*)carry_hp,
                (const uint32_t*)carry_hn, per_slot, (int*)out_ssb,
                (uint32_t*)out_hp, (uint32_t*)out_hn, (int*)xbest,
                (int*)xslot, (int*)xrow};
  return (int)launch_carried(
      (const int4*)node_eq, (const int*)node_len, (const int*)band_nodes,
      (const int8_t*)band_in, (const int8_t*)band_level,
      (const int*)seed_shift, (const int4*)req, (const int*)rows, N2, F, B,
      S, max_in, n_levels, (int*)best_score, (int*)best_slot,
      (int*)best_col, (int8_t*)best_in, ext, (cudaStream_t)stream);
}

extern "C" const char* gct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
