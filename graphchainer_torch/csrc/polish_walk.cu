// Score and backtrace walk over the polish fill's dump, packed for the host.
//
// Replaces: the XLA code graphchainer_tpu/ops/linear_align.py
// _score_from_dump_t + _backtrace_t + pack_ops2 (no Pallas kernel there);
// computes exactly graphchainer_torch/ops/linear_align.py _polish_walk_t.
// Per read: the global score at (read_len - 1, path_len - 1), then a walk
// from that cell back to (-1, -1), one step per edit op (ties: insertion,
// then diagonal, then deletion), failing when no neighbour explains the
// score, when the walk leaves the band, or at ops_cap steps; `touched`
// records whether it ran along a band edge with DP rows beyond it.
//
// What bounds it on the H100: latency.  A walk is a chain of ~read + path
// dependent steps, each a few cached loads from the dump (three cells:
// diagonal, left, up) and the read planes; there is no arithmetic to
// speak of.  As torch ops each step was ~100 small launches.
//
// Design: one thread per read, the walk in registers, dump cells read
// straight from device memory (the fill kernel just wrote them, so they
// sit in L2).  The 2-bit ops are packed on the fly, 16 per word, and
// written once a word fills; the padding past n_ops is all-ones, as
// pack_ops2 makes it from OP_NONE.  Row/word division that can see -1 is
// floor division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr int BIGB = 1 << 26;
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr int OP_MATCH = 0, OP_DEL = 1, OP_INS = 2, OP_MISMATCH = 3;

__device__ __forceinline__ int floordiv32(int a) {   // floor(a / 32)
  return a >= 0 ? a / W : -((-a + W - 1) / W);
}

__device__ __forceinline__ uint32_t above(int rr) {  // bits above row rr % 32
  const int m = rr - floordiv32(rr) * W;
  return m < W - 1 ? (ONES << (m + 1)) : 0u;
}

struct Dump {
  const uint32_t* vp;    // (P, bw, R)
  const uint32_t* vn;
  const int* sb;
  const int* base;       // (P, R)
  int P, bw, R, r;

  __device__ __forceinline__ int cell(int rr, int cc) const {
    if (rr < 0 && cc < 0) return 0;
    if (cc < 0) return rr + 1;
    if (rr < 0) return cc + 1;
    const int cq = min(cc, P - 1);
    const int w = floordiv32(rr) - base[(size_t)cq * R + r];
    if (w < 0 || w >= bw) return BIGB;
    const size_t o = ((size_t)cq * bw + w) * R + r;
    const uint32_t a = above(rr);
    return sb[o] - __popc(vp[o] & a) + __popc(vn[o] & a);
  }
};

__global__ void __launch_bounds__(64)
polish_walk_kernel(Dump d, const uint32_t* __restrict__ planes,  // (4, RW, R)
                   const uint32_t* __restrict__ path,            // (P, R)
                   const int* __restrict__ read_len,
                   const int* __restrict__ path_len, int RW,
                   int max_steps, int ops_cap,
                   long long* __restrict__ out) {   // (R, 3 + ops_cap / 16)
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= d.R) return;
  d.r = r;
  const int R = d.R, P = d.P, bw = d.bw;
  const int rl = read_len[r];
  const int pl = path_len[r];
  const int n_words = ops_cap / 16;
  long long* row = out + (size_t)r * (3 + n_words);

  // global score: row rl - 1 at column pl - 1, word clamped into the band
  {
    const int last = min(max(pl - 1, 0), P - 1);
    const int rr = rl - 1;
    const int wofs = min(max(floordiv32(rr) - d.base[(size_t)last * R + r],
                             0), bw - 1);
    const size_t o = ((size_t)last * bw + wofs) * R + r;
    const uint32_t a = above(rr);
    row[0] = d.sb[o] - __popc(d.vp[o] & a) + __popc(d.vn[o] & a);
  }

  const int rw_cap = (rl + W - 1) / W;
  int rr = rl - 1, cc = pl - 1;
  int s = d.cell(rr, cc);
  bool fail = rl <= 0 || pl <= 0;
  bool done = fail;
  bool touch = false;
  int k = 0;                       // ops emitted
  uint32_t word = ONES;            // ops word being filled
  for (int i = 0; i < max_steps && !done; ++i) {
    const int dg = d.cell(rr - 1, cc - 1);
    const int lf = d.cell(rr, cc - 1);
    const int up = d.cell(rr - 1, cc);
    int sub = 1;
    if (rr >= 0 && cc >= 0) {
      const uint32_t pm = path[(size_t)min(cc, P - 1) * R + r];
      const int rq = min(rr, RW * W - 1);
      const int wq = rq / W, bit = rq % W;
      uint32_t m = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        m |= ((planes[((size_t)b * RW + wq) * R + r] >> bit) & 1u)
             & ((pm >> b) & 1u);
      sub = m ? 0 : 1;
    }
    const bool can_diag = rr >= 0 && cc >= 0 && s == dg + sub;
    const bool can_left = cc >= 0 && s == lf + 1;
    const bool can_up = rr >= 0 && s == up + 1;
    int op;
    if (can_up) op = OP_INS;
    else if (can_diag) op = sub ? OP_MISMATCH : OP_MATCH;
    else if (can_left) op = OP_DEL;
    else { fail = true; break; }
    if (i >= ops_cap) { fail = true; break; }
    if (rr >= 0 && cc >= 0) {
      const int base_c = d.base[(size_t)min(cc, P - 1) * R + r];
      const int w = min(rr, RW * W - 1) / W - base_c;
      if ((w <= 0 && base_c > 0) || (w >= bw - 1 && base_c + bw < rw_cap))
        touch = true;
    }
    if (can_up) { rr -= 1; s = up; }
    else if (can_diag) { rr -= 1; cc -= 1; s = dg; }
    else { cc -= 1; s = lf; }
    const int sh = 2 * (k % 16);
    word = (word & ~(3u << sh)) | ((uint32_t)op << sh);
    ++k;
    if (k % 16 == 0) { row[3 + k / 16 - 1] = (long long)word; word = ONES; }
    done = rr < 0 && cc < 0;
  }
  int wi = k / 16;
  if (k % 16) row[3 + wi++] = (long long)word;
  for (; wi < n_words; ++wi) row[3 + wi] = (long long)ONES;
  const bool complete = done && !fail && rr < 0 && cc < 0;
  row[1] = complete ? k : -1;
  row[2] = touch ? 1 : 0;
}

}  // namespace

extern "C" int polish_walk_launch(const void* dvp, const void* dvn,
                                  const void* dsb, const void* dbase,
                                  const void* planes, const void* path,
                                  const void* read_len, const void* path_len,
                                  int R, int RW, int P, int bw, int max_steps,
                                  int ops_cap, void* out, void* stream) {
  if (R <= 0) return 0;
  if (P <= 0 || bw <= 0 || ops_cap <= 0 || ops_cap % 16)
    return (int)cudaErrorInvalidValue;
  Dump d{(const uint32_t*)dvp, (const uint32_t*)dvn, (const int*)dsb,
         (const int*)dbase, P, bw, R, 0};
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  polish_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      d, (const uint32_t*)planes, (const uint32_t*)path, (const int*)read_len,
      (const int*)path_len, RW, max_steps, ops_cap, (long long*)out);
  return (int)cudaGetLastError();
}
