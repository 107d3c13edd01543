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
// S = 128 slices of a 3 kbp read: ~1 MB moved, ~0.2 G integer operations,
// a few microseconds either way.  What is left is the dependent chain: a
// slot's columns are a serial Myers recurrence (up to 31 columns), a
// slice's slots are a chain of ~3,000 topological levels, and a slot's
// slice s needs its slice s - 1.  So the time is the number of steps of
// the wavefront below times the length of a step, and a step is one warp
// issuing, alone on its scheduler, a slot's column-0 merges and up to 31
// columns of ~27 instructions for each of its 32 lanes at once.
//
// Design, against that chain:
// - One block per fragment, a thread per slice (32, 64 or 128 threads: the
//   slice count rounded up).  A fragment whose in-edges all come from a
//   lower level (every band the callers build from a DAG) runs the slices
//   as a wavefront: thread t takes slice t (then t + 128, ...), and at
//   step k processes the (k - t)-th slot in level order, so slice s of a
//   slot runs one step after slice s - 1 of it and after slice s of its
//   predecessors.  One barrier a step: B + S - 1 steps for S <= 128
//   slices.  A step lasts as long as its slowest warp, so no thread may
//   carry work the others do not.
// - Merges are word operations (merge2): where popcount bounds do not
//   settle which word is lower on every row, the difference of the two
//   words' row scores runs as four byte lanes (rows 8k + j in byte k,
//   biased by 127), eight steps of two adds, which give the rows where the
//   second word is strictly lower; the parity of the difference (a prefix
//   XOR) tells the rows where the lower word changes how the row score
//   moves.  Equal to the row-by-row min (ops/word_merge.py holds the same
//   steps to it on the CPU).  At column 0 a candidate that provably lies
//   on or below the merge so far replaces it without a merge: below the
//   vertical word at later slices, and at slice 0 below the seed word
//   (an in-edge whose end word's boundary is at most base).
// - The free-start merge has a closed form (merge_free): the free-start
//   word's row scores are fbase + r + 1 - [a match in rows 0..r], and a
//   word's row scores minus fbase + r never rise, so the free start wins
//   exactly the rows above the first row where the word's score comes
//   within one of fbase + r: a binary search of five popcounts.  At slice
//   0 it needs no merge at all past column 1: there the column's boundary
//   is the free start's and its rows lie on or below the free start's, so
//   the free-start merge of the next column gives back the column advanced
//   with no boundary change (hin = 0), which is what that column runs.
//   At later slices it runs only from the first column whose boundary
//   (acc_b plus the slice above's bottom-row moves, known before the
//   columns) reaches fbase, which on real bands is almost never.  The
//   slice-0 thread thus runs the same column steps as the others.
// - The other columns are the bare recurrence, unrolled, on registers:
//   the match word of a column is one shared-memory load from the
//   thread's table of its slice's read planes by the column's plane mask
//   (a slot's Eq planes are stored transposed, a nibble a column), loaded
//   a column ahead; the bottom-row and last-row moves go into bit words
//   by funnel shifts, and the bottom score, the boundary and the best end
//   cell come from popcounts and a scan after the loop.
// - Each slice keeps the end words of its last RING slots in shared
//   memory, where a slot's in-edges find them (every band from a DAG puts
//   a slot a few positions after its predecessors); older ones come from
//   the scratch, which every end word is written to as well.  The next
//   step's slot and its first two in-edges are loaded a step ahead.
// - Any other fragment runs its slices one after the other and each level's
//   slots on the threads side by side, a barrier a level; end words are
//   kept per slice parity, and a slot reads a predecessor of a lower level
//   from its own slice and any other from the slice before (the
//   reference's masked commit).
// - Per-slot state (Eq planes, length, level, order position, the previous
//   slice's column-0 bottom score and bottom-row horizontal bits) lives in
//   shared memory: 35 B a slot, 140 KB at B = 4096, with the tables and
//   the ring 196 KB, past the 48 KB default, so the launch raises the
//   block's limit.
// - Columns past a slot's length are not computed (they reach no output).
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, kernel_turns.py): a whole
// 3 kbp read 11.8 ms (2.8 us a step; the earlier design, with 32-row
// merge loops and the free-start merge in every column of slice 0, 44.2
// ms), a step ~5,700 cycles of which ~2,400 column 0 and ~3,400 the
// columns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr int BIG = 1 << 28;
constexpr int IN_NONE = -1;
constexpr int IN_SEED = -2;
constexpr int IN_VERT = -3;
constexpr int NT = 128;                  // threads of the widest block
constexpr int RING = 32;                 // end words a slice keeps (slots)
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr uint32_t BYTE_LSB = 0x01010101u;

struct Word {
  uint32_t vp, vn;
  int sb;
};

__device__ __forceinline__ int before_of(const Word& w) {
  return w.sb - __popc(w.vp) + __popc(w.vn);
}

// One Myers column step (ops/myers.advance_word); returns hout.  The row
// scores it gives do not depend on hin in {0, +1}, only the boundary does.
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

// Set bits of each byte of x.
__device__ __forceinline__ uint32_t byte_popc(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  return (x + (x >> 4)) & 0x0F0F0F0Fu;
}

// Exact elementwise min of two words over their boundary and 32 row
// scores, row r of a word scoring its boundary plus its +1 bits minus its
// -1 bits in rows 0..r (ops/word_merge.merge_words_swar, held to the
// row-by-row min).  d(r) = a's score - b's: b is taken where d >= 1.
__device__ __forceinline__ Word merge2(const Word& a, int ba, const Word& b,
                                       int bb, int& before) {
  const uint32_t pa = a.vp & ~a.vn, na = a.vn & ~a.vp;
  const uint32_t pb = b.vp & ~b.vn, nb = b.vn & ~b.vp;
  const int d0 = ba - bb;
  uint32_t cb;                           // rows where b is strictly lower
  if (d0 + __popc(pa) + __popc(nb) <= 0) {
    cb = 0u;
  } else if (d0 - __popc(na) - __popc(pb) >= 1) {
    cb = ONES;
  } else {
    // here |d| <= 64 on every row: 127 + d in four byte lanes, byte k
    // starting at row 8k - 1 (exclusive byte prefix of the set bits)
    const uint32_t up = byte_popc(pa) + byte_popc(nb);
    const uint32_t dn = byte_popc(na) + byte_popc(pb);
    uint32_t v = (uint32_t)(127 + d0) * BYTE_LSB + (up << 8) * BYTE_LSB
               - (dn << 8) * BYTE_LSB;
    cb = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v += ((pa >> j) & BYTE_LSB) + ((nb >> j) & BYTE_LSB);
      v -= ((na >> j) & BYTE_LSB) + ((pb >> j) & BYTE_LSB);
      cb |= (v & 0x80808080u) >> (7 - j);
    }
  }
  // where the lower word changes, d is -1 or 0 (to a) or 1 or 2 (to b):
  // its parity tells which
  uint32_t px = pa ^ na ^ pb ^ nb;
  px ^= px << 1;
  px ^= px << 2;
  px ^= px << 4;
  px ^= px << 8;
  px ^= px << 16;
  const uint32_t even = ~px ^ ((d0 & 1) ? ONES : 0u);
  const uint32_t cbp = (cb << 1) | (d0 >= 1 ? 1u : 0u);
  const uint32_t keep_a = ~cb & ~cbp, keep_b = cb & cbp;
  const uint32_t to_a = ~cb & cbp, to_b = cb & ~cbp;
  Word m;
  m.vp = (keep_a & pa) | (keep_b & pb) | (to_a & even & pb);
  m.vn = (keep_a & na) | (keep_b & nb) | (to_a & even & nb)
       | (to_a & ~even & ~(pb | nb)) | (to_b & ~even & ~(pa | na))
       | (to_b & even & pa);
  m.sb = (cb >> 31) ? bb + __popc(pb) - __popc(nb)
                    : ba + __popc(pa) - __popc(na);
  before = min(ba, bb);
  return m;
}

// Rows 0..r of a word.
__device__ __forceinline__ uint32_t low_rows(int r) {
  return r >= 31 ? ONES : ((2u << r) - 1u);
}

// merge2 of w (boundary wb) with the free-start word of a column of match
// bits eq: the all-insertion word of bottom score fbase + 32 advanced into
// the column, boundary fb (fbase at slice 0, fbase + 1 after), row r
// fbase + r + 1 - [a match in rows 0..r] (ops/word_merge.merge_free_start).
// D(r) = w's row r - fbase - r never rises (c0 at the boundary, minus one
// for each row without a +1 bit and one more for each -1 bit); the free
// start gives the rows above the first row p1 with D <= 0, w the rest.
__device__ __forceinline__ Word merge_free(const Word& w, int wb, uint32_t eq,
                                           int fbase, int fb, int& before) {
  const uint32_t pa = w.vp & ~w.vn, na = w.vn & ~w.vp;
  const uint32_t ua = ~pa;
  const int c0 = wb - fbase + 1;
  auto units = [&](int r) {
    const uint32_t m = low_rows(r);
    return __popc(ua & m) + __popc(na & m);
  };
  int p1 = 0;
  if (c0 > 0) {
    if (units(31) < c0) {
      p1 = 32;
    } else {
#pragma unroll
      for (int st = 16; st; st >>= 1)
        if (units(p1 + st - 1) < c0) p1 += st;
    }
  }
  const int k = eq ? __ffs(eq) - 1 : W;   // the first match row
  const uint32_t lo = p1 >= 32 ? ONES : ((1u << p1) - 1u);
  const uint32_t hi = p1 >= 31 ? 0u : (ONES << (p1 + 1));
  Word m;
  m.vp = (~(k < W ? 1u << k : 0u) & lo) | (pa & hi);
  m.vn = na & hi;
  if (p1 >= 1 && p1 <= 31) {             // from the free start to w
    const int delta = (c0 - units(p1)) - (k >= p1 ? 1 : 0) + 1;
    m.vp |= (delta == 1 ? 1u : 0u) << p1;
    m.vn |= (delta == -1 ? 1u : 0u) << p1;
  }
  const int mb = min(wb, fb);
  const int m0 = p1 == 0 ? wb + (int)(pa & 1u) - (int)(na & 1u)
                         : fbase + 1 - (int)(eq & 1u);
  m.vp = (m.vp & ~1u) | (m0 - mb == 1 ? 1u : 0u);
  m.vn = (m.vn & ~1u) | (m0 - mb == -1 ? 1u : 0u);
  m.sb = p1 == 32 ? fbase + W - (eq ? 1 : 0)
                  : wb + __popc(pa) - __popc(na);
  before = mb;
  return m;
}

// The 4-bit plane mask of column c of a slot (its Eq planes transposed:
// column c in bits 4 (c % 8) .. 4 (c % 8) + 3 of word c / 8).
__device__ __forceinline__ uint32_t nib_at(const uint4& q, int c) {
  const uint32_t x = c < 8 ? q.x : c < 16 ? q.y : c < 24 ? q.z : q.w;
  return (x >> ((c & 7) * 4)) & 0xFu;
}

// The low 8 bits of x to every 4th bit.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x &= 0xFFu;
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// A slot's four Eq planes as column nibbles (nib_at).
__device__ __forceinline__ uint4 transpose_planes(const uint4& e) {
  auto word = [&](int k) {
    const int sh = 8 * k;
    return spread4(e.x >> sh) | (spread4(e.y >> sh) << 1)
         | (spread4(e.z >> sh) << 2) | (spread4(e.w >> sh) << 3);
  };
  return make_uint4(word(0), word(1), word(2), word(3));
}

__device__ __forceinline__ int score_masked(const Word& w, uint32_t m) {
  return w.sb - __popc(w.vp & m) + __popc(w.vn & m);
}

// A fragment's view of its arrays.
struct Frag {
  const int16_t* bin;     // (B, max_in) in-edges
  int B, max_in, nt;
  int end_slice;          // the slice of the fragment's last row
  int end_row;            // and its row there
  uint32_t end_mask;      // rows strictly below the last row
  int base;               // seed_base
  bool full_start;
  // shared memory
  const uint4* code;      // [B] slot Eq planes as column nibbles, trimmed
  const int8_t* slen;     // [B] slot lengths, seed-trimmed, in -1..33
  const int16_t* lvl;     // [B] levels, -1 outside 0..n_levels - 1
  const uint16_t* pos;    // [B] position in level order
  int* ssb;               // [B] previous slice: column-0 bottom score
  uint32_t* hp;           // [B]   and bottom-row horizontal +1 / -1 bits
  uint32_t* hn;
};

// Slice s of slot b (at position p of the level order): column-0 merge,
// columns, state, end word, best_in and (at the end slice) the slot's best
// end cell.  rqt: this thread's table of the slice's match words by plane
// mask (stride nt); u0, u1: the slot's first two in-edges (loaded a step
// ahead); cur: the end-word buffer of slice s; prev: that of slice s - 1
// (read for an in-edge that does not come from a lower level: only off
// the wavefront); ring: this thread's ring of end words (WAVE only).
template <typename PTR, bool WAVE>
__device__ __forceinline__ void process(const Frag& fr, int b, int p, int s,
                                        const uint32_t* rqt, int u0, int u1,
                                        uint4* cur, const uint4* prev,
                                        uint32_t* ring, PTR* bin_out,
                                        int* end_score, int* end_col) {
  const int nt = fr.nt;                  // ring: [slot][vp, vn, sb][thread]
  const int len = fr.slen[b];
  const bool act = len > 0;
  const bool seed = b == 0;
  const uint4 code = fr.code[b];
  const bool first = s == 0;
  auto eq_of = [&](int c) { return rqt[nib_at(code, c) * nt]; };
  const uint32_t eq0 = eq_of(0);
  const int pssb = first ? BIG : fr.ssb[b];
  const uint32_t php = first ? 0u : fr.hp[b];
  const uint32_t phn = first ? 0u : fr.hn[b];

  // ---- column 0: the merge of the candidates.  Invalid candidates are
  // the word X = (ONES, 0, BIG); the merge starts from I = (0, 0, BIG).
  Word acc{0u, 0u, BIG};
  int acc_b = BIG;
  int nvalid = 0;
  bool acc_src = false;                  // acc is the vertical or seed word
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
    // the seed word: rows base + r + 1 - [a match in rows 0..r], boundary
    // base + 1; an in-edge word whose end word's boundary is at most base
    // lies on or below it on every row (its row r is at most base + r, or
    // base + r + 1 before the first match), and such a word's boundary is
    // at most base + 1: the source test in add() below
    const bool valid = fr.full_start ? (act || seed) : seed;
    Word w{ONES, 0u, fr.base + W};
    advance(w, eq0, 1);
    add(w, valid, IN_SEED);
    acc_src = valid;
  } else {
    const bool valid = act && pssb < BIG;
    add(Word{ONES, 0u, pssb + W}, valid, IN_VERT);
    acc_src = valid;
  }
  for (int e = 0; e < fr.max_in; ++e) {
    const int u = e == 0 ? u0 : e == 1 ? u1
                                       : fr.bin[(size_t)b * fr.max_in + e];
    if (u < 0 || !act) { have_invalid = true; continue; }
    const int uc = min(u, fr.B - 1);
    const int lu = fr.lvl[uc];
    if (lu < 0) { have_invalid = true; continue; }
    Word w;
    if (WAVE) {                          // every in-edge from a lower level
      const int q = fr.pos[uc];
      if (p - q <= RING) {
        const uint32_t* r = ring + (q & (RING - 1)) * 3 * nt;
        w = Word{r[0], r[nt], (int)r[2 * nt]};
      } else {
        const uint4 ew = cur[uc];
        w = Word{ew.x, ew.y, (int)ew.z};
      }
    } else {
      uint4 ew;
      if (lu < fr.lvl[b]) {
        ew = cur[uc];
      } else if (!first) {
        ew = prev[uc];
      } else {
        have_invalid = true;             // the initial end word
        continue;
      }
      w = Word{ew.x, ew.y, (int)ew.z};
    }
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
  const int last = min(len, W) - 1;
  const int fbase = fr.base + W * s;
  Word w = acc;
  int wb = acc_b;
  uint32_t hp_acc = 0u, hn_acc = 0u;
  int best_sc = (at_end && act) ? score_masked(acc, fr.end_mask) : BIG;
  int best_cl = 0;
  int esc = best_sc;                     // the last row's score (at_end)
  // a column that may take the free-start merge: advance, then merge
  // where the column's boundary reaches the free start's (below it the
  // free start wins no row)
  auto slow = [&](int c) {
    const uint32_t eqc = eq_of(c);
    const int hin = first ? 1
                          : (int)((php >> c) & 1u) - (int)((phn >> c) & 1u);
    const int hout = advance(w, eqc, hin);
    wb += hin;
    hp_acc |= (hout > 0 ? 1u : 0u) << c;
    hn_acc |= (hout < 0 ? 1u : 0u) << c;
    if (fr.full_start && wb >= fbase) {
      int nb;
      w = merge_free(w, wb, eqc, fbase, first ? fbase : fbase + 1, nb);
      wb = nb;
    }
    esc = score_masked(w, fr.end_mask);
    if (esc < best_sc) { best_sc = esc; best_cl = c; }
  };
  // Columns 1 .. pre and post .. last run slow(), the rest the plain
  // recurrence below.  With full_start: at slice 0, column 1 merges (its
  // boundary lies above the free start's), and from column 2 on the merge
  // folds into hin = 0 (the note above) once column 1's boundary is the
  // free start's; at later slices the boundary is acc_b plus the moves of
  // the slice above's bottom row, and the merge runs from the first column
  // where it reaches fbase (rare: the free start lies 32 rows above).
  int pre = 0, post = last + 1;
  if (fr.full_start && last >= 1) {
    if (first) {
      pre = 1;
      slow(1);
      if (wb != fbase) post = 2;
    } else if (wb + __popc(php & low_rows(last)) >= fbase) {
      int x = wb;
      for (int c = 1; c <= last; ++c) {
        x += (int)((php >> c) & 1u) - (int)((phn >> c) & 1u);
        if (x >= fbase) { post = c; break; }
      }
    }
  }
  const int lo = pre + 1, hi = post - 1;
  if (hi >= lo) {
    const uint32_t hpos_all = first ? (fr.full_start ? 0u : ONES) : php;
    const uint32_t hneg_all = first ? 0u : phn;
    const int esh = 31 - fr.end_row;
    uint32_t vp = w.vp, vn = w.vn;
    uint32_t hpa = 0u, hna = 0u, epa = 0u, ena = 0u;   // column bits, lo first
    uint32_t eqn = eq_of(lo);            // the match words a column ahead
#pragma unroll
    for (int c = 1; c < W; ++c) {
      if (c > hi) break;
      if (c >= lo) {
        const uint32_t hneg = (hneg_all >> c) & 1u;
        const uint32_t hpos = (hpos_all >> c) & 1u;
        const uint32_t eq = eqn | hneg;
        if (c + 1 < W) eqn = eq_of(c + 1);
        const uint32_t xv = eq | vn;
        const uint32_t xh = (((eq & vp) + vp) ^ vp) | eq;
        uint32_t ph = vn | ~(xh | vp);
        uint32_t mh = vp & xh;
        hpa = __funnelshift_l(ph, hpa, 1);
        hna = __funnelshift_l(mh, hna, 1);
        epa = __funnelshift_l(ph << esh, epa, 1);
        ena = __funnelshift_l(mh << esh, ena, 1);
        ph = (ph << 1) | hpos;
        mh = (mh << 1) | hneg;
        vp = mh | ~(xv | ph);
        vn = ph & xv;
      }
    }
    const int sh = 31 - hi;              // column c's bits to bit c
    const uint32_t hps = __brev(hpa) >> sh, hns = __brev(hna) >> sh;
    const uint32_t seg = low_rows(hi) & ~((1u << lo) - 1u);
    hp_acc |= hps;
    hn_acc |= hns;
    w.vp = vp;
    w.vn = vn;
    w.sb += __popc(hps) - __popc(hns);
    wb += __popc(hpos_all & seg) - __popc(hneg_all & seg);
    if (at_end && act) {
      const uint32_t eps = __brev(epa) >> sh, ens = __brev(ena) >> sh;
      for (int c = lo; c <= hi; ++c) {
        esc += (int)((eps >> c) & 1u) - (int)((ens >> c) & 1u);
        if (esc < best_sc) { best_sc = esc; best_cl = c; }
      }
    }
  }
  for (int c = post; c <= last; ++c) slow(c);

  Word ew = len <= W ? w : Word{0u, 0u, BIG};
  if (!(act || (seed && len == 0))) ew.sb = BIG;
  fr.hp[b] = hp_acc;
  fr.hn[b] = hn_acc;
  cur[b] = make_uint4(ew.vp, ew.vn, (uint32_t)ew.sb, 0u);
  if (WAVE) {
    uint32_t* r = ring + (p & (RING - 1)) * 3 * nt;
    r[0] = ew.vp;
    r[nt] = ew.vn;
    r[2 * nt] = (uint32_t)ew.sb;
  }
  if (at_end && best_sc < BIG) {
    end_score[b] = best_sc;
    end_col[b] = best_cl;
  }
}

// This thread's table of a slice's match words by plane mask: entry m is
// the OR of the read planes whose bit m has.
__device__ __forceinline__ void fill_rq_table(uint32_t* rqt, int nt,
                                              const uint4& rq) {
#pragma unroll
  for (int m = 0; m < 16; ++m)
    rqt[m * nt] = ((m & 1) ? rq.x : 0u) | ((m & 2) ? rq.y : 0u)
                | ((m & 4) ? rq.z : 0u) | ((m & 8) ? rq.w : 0u);
}

// Dynamic shared memory of a block: the 16- and 4-byte slot arrays, the
// threads' match-word tables, the ring (or, before the wavefront and off
// it, the level table), then the 2- and 1-byte slot arrays.
struct Layout {
  size_t code, ssb, hp, hn, rqt, region, order, pos, lvl, slen, bytes;
  __host__ __device__ Layout(int B, int n_levels, int nt) {
    code = 0;
    ssb = code + (size_t)B * 16;
    hp = ssb + (size_t)B * 4;
    hn = hp + (size_t)B * 4;
    rqt = hn + (size_t)B * 4;
    region = rqt + (size_t)16 * nt * 4;
    const size_t ring = (size_t)RING * 3 * nt * 4;
    const size_t levels = (size_t)(n_levels + 1) * 4;
    order = region + (ring > levels ? ring : levels);
    pos = order + (size_t)B * 2;
    lvl = pos + (size_t)B * 2;
    slen = lvl + (size_t)B * 2;
    bytes = slen + (size_t)B;
  }
};

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
  const int nt = blockDim.x;
  const Layout L(B, n_levels, nt);
  uint4* code = (uint4*)(smem_raw + L.code);
  int* ssb = (int*)(smem_raw + L.ssb);
  uint32_t* hp = (uint32_t*)(smem_raw + L.hp);
  uint32_t* hn = (uint32_t*)(smem_raw + L.hn);
  uint32_t* rqt = (uint32_t*)(smem_raw + L.rqt) + t;
  int* cur = (int*)(smem_raw + L.region);          // [n_levels] level ends
  uint32_t* ring = (uint32_t*)(smem_raw + L.region);
  uint16_t* order = (uint16_t*)(smem_raw + L.order);
  uint16_t* pos = (uint16_t*)(smem_raw + L.pos);
  int16_t* lvl = (int16_t*)(smem_raw + L.lvl);
  int8_t* slen = (int8_t*)(smem_raw + L.slen);
  __shared__ int red_s[NT];
  __shared__ int red_b[NT];

  const size_t fb = (size_t)f * B;
  const int fr_rows = rows[f];
  PTR* bin_f = best_in + fb * S;
  int* es_f = end_score + fb;
  int* ec_f = end_col + fb;

  // ---- the fragment's slots
  for (int i = t; i <= n_levels; i += nt) cur[i] = 0;
  __syncthreads();
  for (int b = t; b < B; b += nt) {
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
    code[b] = transpose_planes(e);
    slen[b] = (int8_t)min(max(len, -1), W + 1);
    const int l = band_level[fb + b];
    const bool live = l >= 0 && l < n_levels;
    lvl[b] = (int16_t)(live ? l : -1);
    es_f[b] = BIG;
    ec_f[b] = 0;
    if (live) {
      atomicAdd(&cur[l], 1);
    } else {
      for (int s = 0; s < S; ++s) bin_f[(size_t)b * S + s] = (PTR)IN_NONE;
    }
  }
  __syncthreads();
  // exclusive scan of the level counts: chunks of nt threads
  {
    const int chunk = (n_levels + nt - 1) / nt;
    const int lo = min(t * chunk, n_levels), hi = min(lo + chunk, n_levels);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += cur[i];
    red_s[t] = sum;
    __syncthreads();
    if (t == 0) {
      int run = 0;
      for (int i = 0; i < nt; ++i) { const int v = red_s[i]; red_s[i] = run; run += v; }
    }
    __syncthreads();
    int run = red_s[t];
    for (int i = lo; i < hi; ++i) { const int v = cur[i]; cur[i] = run; run += v; }
  }
  __syncthreads();
  // scatter: cur[l] ends at the end of level l; regular: every in-edge
  // that can be valid comes from a lower level
  int irregular = 0;
  for (int b = t; b < B; b += nt) {
    const int l = lvl[b];
    if (l < 0) continue;
    const int i = atomicAdd(&cur[l], 1);
    order[i] = (uint16_t)b;
    pos[b] = (uint16_t)i;
    for (int e = 0; e < max_in; ++e) {
      const int u = band_in[(fb + b) * max_in + e];
      if (u < 0) continue;
      const int lu = lvl[min(u, B - 1)];
      if (lu >= 0 && lu >= l) irregular = 1;
    }
  }
  irregular = __syncthreads_or(irregular);
  const int n_proc = cur[n_levels - 1];

  Frag fr;
  fr.bin = band_in + fb * max_in;
  fr.B = B; fr.max_in = max_in; fr.nt = nt;
  fr.end_slice = (fr_rows - 1) >= 0 ? (fr_rows - 1) / W : -1;
  {
    const int er = ((fr_rows - 1) % W + W) % W;
    fr.end_row = er;
    fr.end_mask = er < W - 1 ? (ONES << (er + 1)) : 0u;
  }
  fr.base = seed_base != nullptr ? seed_base[f] : 0;
  fr.full_start = full_start != 0;
  fr.code = code; fr.slen = slen; fr.lvl = lvl; fr.pos = pos;
  fr.ssb = ssb; fr.hp = hp; fr.hn = hn;
  uint4* ebuf = scratch + (size_t)f * T * B;
  auto edge = [&](int b, int e) {
    return e < max_in ? (int)fr.bin[(size_t)b * max_in + e] : -1;
  };

  if (!irregular) {
    __syncthreads();                     // the level table becomes the ring
    // the slice wavefront: thread t runs slice r * nt + t
    for (int r0 = 0; r0 < S; r0 += nt) {
      const int s = r0 + t;
      const int lanes = min(nt, S - r0);
      fill_rq_table(rqt, nt, s < S ? req[(size_t)f * S + s]
                                   : make_uint4(0, 0, 0, 0));
      uint4* eb = ebuf + (size_t)min(t, T - 1) * B;
      const int steps = n_proc + lanes - 1;
      // the next step's slot and its first in-edges, loaded a step ahead
      int bn = 0, u0n = -1, u1n = -1;
      auto fetch = [&](int q) {
        if (t < lanes && q >= 0 && q < n_proc) {
          bn = order[q];
          u0n = edge(bn, 0);
          u1n = edge(bn, 1);
        }
      };
      fetch(-t);
      for (int k = 0; k < steps; ++k) {
        const int p = k - t;
        const int b = bn, u0 = u0n, u1 = u1n;
        fetch(p + 1);
        if (t < lanes && p >= 0 && p < n_proc)
          process<PTR, true>(fr, b, p, s, rqt, u0, u1, eb, eb, ring + t,
                             bin_f + (size_t)b * S + s, es_f, ec_f);
        __syncthreads();
      }
    }
  } else {
    // level by level: the level's slots side by side
    for (int s = 0; s < S; ++s) {
      fill_rq_table(rqt, nt, req[(size_t)f * S + s]);
      uint4* eb = ebuf + (size_t)(s & 1) * B;
      const uint4* pb = ebuf + (size_t)((s + 1) & 1) * B;
      for (int l = 0; l < n_levels; ++l) {
        const int st = l == 0 ? 0 : cur[l - 1];
        const int en = cur[l];
        if (st == en) continue;
        for (int i = st + t; i < en; i += nt) {
          const int b = order[i];
          process<PTR, false>(fr, b, i, s, rqt, edge(b, 0), edge(b, 1), eb,
                              pb, nullptr, bin_f + (size_t)b * S + s, es_f,
                              ec_f);
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();

  // ---- the best slot: lowest end score, then lowest slot
  int bs = BIG + 1, bb = 0;
  for (int b = t; b < B; b += nt) {
    const int v = es_f[b];
    if (v < bs) { bs = v; bb = b; }
  }
  red_s[t] = bs;
  red_b[t] = bb;
  __syncthreads();
  for (int h = nt / 2; h > 0; h >>= 1) {
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

template <typename PTR>
cudaError_t launch(const void* node_eq, const void* node_len,
                   const void* band_nodes, const void* band_in,
                   const void* band_level, const void* seed_shift,
                   const void* req, const void* rows, const void* seed_base,
                   int N2, int F, int B, int S, int max_in, int n_levels,
                   int full_start, int T, void* scratch, void* best_score,
                   void* best_slot, void* best_col, void* best_in,
                   void* end_score, void* end_col, cudaStream_t stream) {
  const int nt = S <= 32 ? 32 : S <= 64 ? 64 : NT;
  const size_t bytes = Layout(B, n_levels, nt).bytes;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frag_wide_kernel<PTR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  frag_wide_kernel<PTR><<<F, nt, bytes, stream>>>(
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
