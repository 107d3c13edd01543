// Banded fragment-to-graph Myers DP, fresh windows (the CLC fragment stage).
//
// Replaces: graphchainer_tpu/ops/pallas_frag.py::frag_core_pallas (body
// _kernel).  Computes exactly graphchainer_torch/ops/frag_align.py
// _frag_core_t (= the JAX _frag_core_t with carried, want_state and
// want_xcells off): per fragment, per 32-row slice, per topological level,
// every band slot of the level merges its candidate words (seed injection
// on slice 0, vertical carry on later slices, up to max_in in-band
// predecessors advanced one column) by exact elementwise min over 33
// expanded row scores, then advances its remaining columns; the winning
// candidate of each slot and slice goes to best_in, the best end cell to
// best_score / best_slot / best_col.
//
// What bounds it on the H100: integer ALU and __popc.  A slot costs about
// 33 adds and mins per candidate for the merge plus ~20 ops per column;
// memory traffic is small (a few words in, B*S bytes out per fragment).
//
// Design: one thread per fragment.  The Pallas kernel put fragments on the
// 128 VPU lanes and evaluated every slot at every level under masks; here
// a thread sorts its slots by level once and visits each slot once per
// slice, so pad slots and other levels cost nothing.  The 33 row scores of
// the merge are running prefix sums of the candidate's delta bits, held in
// registers (fully unrolled).  Per-slot end words and the boundary state
// of the previous slice live in per-thread arrays (local memory, cached).
// Inputs keep the lane-major (..., F) layout, so neighbouring threads read
// neighbouring words.  Within a level every slot reads its predecessors'
// end words as they were before the level (as the reference's masked
// commit does): results of a level are staged and committed after it.
// Integer division that can see a negative operand is floor division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr int BIG = 1 << 28;
constexpr int IN_NONE = -1;
constexpr int IN_SEED = -2;
constexpr int IN_VERT = -3;
constexpr uint32_t ONES = 0xFFFFFFFFu;

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

__device__ __forceinline__ int score_masked(uint32_t vp, uint32_t vn, int sb,
                                            uint32_t m) {
  return sb - __popc(vp & m) + __popc(vn & m);
}

template <int MAXB>
__global__ void __launch_bounds__(128)
frag_core_kernel(const uint32_t* __restrict__ slot_eq,     // (4, B, F)
                 const int* __restrict__ slot_len,         // (B, F)
                 const int* __restrict__ band_in,          // (max_in, B, F)
                 const int* __restrict__ band_level,       // (B, F)
                 const uint32_t* __restrict__ req,         // (S, 4, F)
                 const int* __restrict__ frag_len,         // (F,)
                 const int* __restrict__ seed_base,        // (F,)
                 int F, int B, int S, int max_in, int n_levels,
                 int* __restrict__ best_score, int* __restrict__ best_slot,
                 int* __restrict__ best_col,
                 int8_t* __restrict__ best_in) {           // (F, B, S)
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;

  uint32_t evp[MAXB], evn[MAXB];   // committed end words (persist)
  int esb[MAXB];
  uint32_t pvp[MAXB], pvn[MAXB];   // staged end words of the open level
  int psb[MAXB];
  int ssb[MAXB];                   // previous slice: column-0 bottom score
  uint32_t hp[MAXB], hn[MAXB];     //   and bottom-row horizontal deltas
  int nssb[MAXB];                  // this slice's values of the same
  uint32_t nhp[MAXB], nhn[MAXB];
  int esc[MAXB], ecl[MAXB];        // best end score / column per slot
  int order[MAXB], olev[MAXB];     // processed slots sorted by level
  int n_order = 0;

  for (int b = 0; b < B; ++b) {
    evp[b] = 0; evn[b] = 0; esb[b] = BIG;
    ssb[b] = BIG; hp[b] = 0; hn[b] = 0;
    esc[b] = BIG; ecl[b] = 0;
    const int l = band_level[(size_t)b * F + f];
    if (l >= 0 && l < n_levels) {          // stable insertion by level
      int q = n_order++;
      while (q > 0 && olev[q - 1] > l) {
        order[q] = order[q - 1]; olev[q] = olev[q - 1]; --q;
      }
      order[q] = b; olev[q] = l;
    }
    for (int s = 0; s < S; ++s) best_in[((size_t)f * B + b) * S + s] = IN_NONE;
  }

  const int fl = frag_len[f];
  const int end_slice = floordiv(fl - 1, W);
  const int er = (fl - 1) - end_slice * W;            // floor mod, 0..31
  const uint32_t erm = er < W - 1 ? (ONES << (er + 1)) : 0u;
  const int b0_sb = seed_base[f] + W;                 // source_word(base)

  for (int s = 0; s < S; ++s) {
    uint32_t rq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) rq[k] = req[((size_t)s * 4 + k) * F + f];
    const bool at_end = end_slice == s;
    for (int b = 0; b < B; ++b) { nssb[b] = BIG; nhp[b] = 0; nhn[b] = 0; }

    int pos = 0;
    while (pos < n_order) {
      const int g0 = pos;
      const int lv = olev[g0];
      for (; pos < n_order && olev[pos] == lv; ++pos) {
        const int b = order[pos];
        const size_t bf = (size_t)b * F + f;
        const int slen = slot_len[bf];
        const bool active = slen > 0;
        uint32_t seq[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) seq[k] = slot_eq[(size_t)k * B * F + bf];
        uint32_t eq0 = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) if (seq[k] & 1u) eq0 |= rq[k];

        int before = BIG;
        int rows[W];
#pragma unroll
        for (int r = 0; r < W; ++r) rows[r] = BIG;
        int cbest = IN_NONE;
        int csb_run = BIG;
        const int pssb = ssb[b];

        if (s == 0) {
          // seed injection: advance the boundary word one column
          const bool seed_valid = b == 0;
          uint32_t avp = ONES, avn = 0;
          int asb = b0_sb;
          advance(avp, avn, asb, eq0, 1);
          if (!seed_valid) { avp = ONES; avn = 0; asb = BIG; }
          acc_add(before, rows, avp, avn, asb);
          const bool better = asb < csb_run;
          csb_run = min(csb_run, asb);
          if (seed_valid && better) cbest = IN_SEED;
        } else {
          // vertical carry: source_word(prev ssb), S(r) = ssb + r + 1
          const bool valid = active && pssb < BIG;
          const int s0 = valid ? pssb : BIG;
          before = min(before, s0);
#pragma unroll
          for (int r = 0; r < W; ++r) rows[r] = min(rows[r], s0 + r + 1);
          const int vsb = valid ? pssb + W : BIG;
          const bool better = vsb < csb_run;
          csb_run = min(csb_run, vsb);
          if (valid && better) cbest = IN_VERT;
        }

        for (int e = 0; e < max_in; ++e) {
          const int u = band_in[(size_t)e * B * F + bf];
          uint32_t uvp = 0, uvn = 0;
          int usb = BIG;
          if (u >= 0 && u < B) { uvp = evp[u]; uvn = evn[u]; usb = esb[u]; }
          const bool valid = u >= 0 && active && usb < BIG;
          int hin = 1;
          if (s > 0) {
            const int ubs = usb - __popc(uvp) + __popc(uvn);
            hin = pssb >= BIG ? 1 : max(-1, min(1, pssb - ubs));
          }
          advance(uvp, uvn, usb, eq0, hin);
          if (!valid) { uvp = ONES; uvn = 0; usb = BIG; }
          acc_add(before, rows, uvp, uvn, usb);
          const bool better = usb < csb_run;
          csb_run = min(csb_run, usb);
          if (valid && better) cbest = u;
        }

        // repack: bits only where adjacent row scores differ by +-1
        uint32_t cvp = 0, cvn = 0;
        {
          int prev = before;
#pragma unroll
          for (int r = 0; r < W; ++r) {
            const int d = rows[r] - prev;
            cvp |= (d == 1 ? 1u : 0u) << r;
            cvn |= (d == -1 ? 1u : 0u) << r;
            prev = rows[r];
          }
        }
        int csb = rows[W - 1];
        if (s == 0 && b == 0 && slen == 0) {   // len-0 seed slot
          cvp = ONES; cvn = 0; csb = b0_sb; cbest = IN_SEED;
        }
        const int col0_sb = csb;

        int best_sc = (at_end && active) ? score_masked(cvp, cvn, csb, erm)
                                         : BIG;
        int best_cl = 0;
        uint32_t wvp = cvp, wvn = cvn;
        int wsb = csb;
        uint32_t hp_acc = 0, hn_acc = 0;
        uint32_t evp_c = slen <= 1 ? wvp : 0u;
        uint32_t evn_c = slen <= 1 ? wvn : 0u;
        int esb_c = slen <= 1 ? wsb : BIG;
        // columns past the slot's length feed nothing observable
        const int ncol = min(slen, W);
        const uint32_t php = hp[b], phn = hn[b];
        for (int c = 1; c < ncol; ++c) {
          uint32_t eqc = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) if ((seq[k] >> c) & 1u) eqc |= rq[k];
          const int hin = s > 0 ? (int)((php >> c) & 1u) - (int)((phn >> c) & 1u)
                                : 1;
          const int hout = advance(wvp, wvn, wsb, eqc, hin);
          hp_acc |= (hout > 0 ? 1u : 0u) << c;
          hn_acc |= (hout < 0 ? 1u : 0u) << c;
          if (at_end) {
            const int sr = score_masked(wvp, wvn, wsb, erm);
            if (sr < best_sc) { best_sc = sr; best_cl = c; }
          }
          if (c == slen - 1) { evp_c = wvp; evn_c = wvn; esb_c = wsb; }
        }
        if (!(active || (b == 0 && slen == 0))) esb_c = BIG;

        const int q = pos - g0;
        pvp[q] = evp_c; pvn[q] = evn_c; psb[q] = esb_c;
        nssb[b] = col0_sb; nhp[b] = hp_acc; nhn[b] = hn_acc;
        if (best_sc < esc[b]) { esc[b] = best_sc; ecl[b] = best_cl; }
        best_in[((size_t)f * B + b) * S + s] = (int8_t)cbest;
      }
      for (int q = g0; q < pos; ++q) {       // commit the level
        const int b = order[q];
        evp[b] = pvp[q - g0]; evn[b] = pvn[q - g0]; esb[b] = psb[q - g0];
      }
    }
    for (int b = 0; b < B; ++b) { ssb[b] = nssb[b]; hp[b] = nhp[b]; hn[b] = nhn[b]; }
  }

  int bs = esc[0], bslot = 0, bcol = ecl[0];
  for (int b = 1; b < B; ++b) {
    if (esc[b] < bs) { bs = esc[b]; bslot = b; bcol = ecl[b]; }
  }
  best_score[f] = bs;
  best_slot[f] = bslot;
  best_col[f] = bcol;
}

template <int MAXB>
cudaError_t launch(const uint32_t* slot_eq, const int* slot_len,
                   const int* band_in, const int* band_level,
                   const uint32_t* req, const int* frag_len,
                   const int* seed_base, int F, int B, int S, int max_in,
                   int n_levels, int* best_score, int* best_slot,
                   int* best_col, int8_t* best_in, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (F + threads - 1) / threads;
  frag_core_kernel<MAXB><<<blocks, threads, 0, stream>>>(
      slot_eq, slot_len, band_in, band_level, req, frag_len, seed_base, F, B,
      S, max_in, n_levels, best_score, best_slot, best_col, best_in);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frag_core_launch(const void* slot_eq, const void* slot_len,
                                const void* band_in, const void* band_level,
                                const void* req, const void* frag_len,
                                const void* seed_base, int F, int B, int S,
                                int max_in, int n_levels, void* best_score,
                                void* best_slot, void* best_col,
                                void* best_in, void* stream) {
  if (F <= 0) return 0;
  if (B < 1 || B > 128) return (int)cudaErrorInvalidValue;
  auto args = [&](auto launcher) {
    return launcher((const uint32_t*)slot_eq, (const int*)slot_len,
                    (const int*)band_in, (const int*)band_level,
                    (const uint32_t*)req, (const int*)frag_len,
                    (const int*)seed_base, F, B, S, max_in, n_levels,
                    (int*)best_score, (int*)best_slot, (int*)best_col,
                    (int8_t*)best_in, (cudaStream_t)stream);
  };
  cudaError_t err;
  if (B <= 32) err = args(launch<32>);
  else if (B <= 64) err = args(launch<64>);
  else err = args(launch<128>);
  return (int)err;
}

extern "C" const char* gct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
