// Banded linear Myers fill of each read against its stitched path (polish).
//
// Replaces: graphchainer_tpu/ops/pallas_polish2.py::polish_core_pallas
// (body _kernel).  Computes exactly graphchainer_torch/ops/linear_align.py
// _polish_core_t (= the JAX _polish_core_t): bw words of 32 read rows in a
// diagonal band that follows the read/path length ratio column by column
// (band_base, float32), advanced with the Myers recurrence; every column's
// band words are dumped for the score and the backtrace.
//
// What bounds it on the H100: the dump.  Each column writes 12 * bw bytes
// per read (vp, vn, sb) plus the band base, against ~20 integer ops per
// word; a read has no parallelism inside a column (the horizontal carry
// runs from word w to w + 1).
//
// Design: one thread per read, band state in registers (bw is a template
// parameter, loops fully unrolled).  The dump is indexed [col][word][read],
// so a warp's stores are coalesced.  The Pallas kernel kept a rolling
// window of read-plane words (the TPU has no vector gathers) with a fast
// branch for band shifts of 0 or 1 and a slow branch that rebuilt the
// window.  Whenever the reference reads the window, its first bw words
// equal the read planes at rows of the current band, so this kernel loads
// those plane words directly (L1/L2-cached, coalesced across reads) and a
// band shift of k words is k single-word shifts that fill with the
// all-insertion word bot_sb + W * j; the dump is the same.  band_base
// rounds as JAX float32 does: __fdiv_rn / __fmul_rn, truncation toward 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr uint32_t ONES = 0xFFFFFFFFu;

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

template <int BW>
__global__ void __launch_bounds__(64)
polish_core_kernel(const uint32_t* __restrict__ planes,   // (4, RW, R)
                   const uint32_t* __restrict__ path,     // (P, R)
                   const int* __restrict__ read_len,      // (R,)
                   const int* __restrict__ path_len,      // (R,)
                   int R, int RW, int P,
                   uint32_t* __restrict__ dvp,            // (P, BW, R)
                   uint32_t* __restrict__ dvn,            // (P, BW, R)
                   int* __restrict__ dsb,                 // (P, BW, R)
                   int* __restrict__ dbase) {             // (P, R)
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int rlen = read_len[r];
  const int plen = path_len[r];
  const int pl1 = max(plen, 1);
  const int rw_cap = (rlen + W - 1) / W;   // read_len >= 0
  const int ub = max(rw_cap - BW, 0);
  const float scale = __fdiv_rn((float)rlen, (float)pl1);

  auto band_base = [&](int col) {
    const int cc = min(col, pl1 - 1);
    const float target = __fmul_rn((float)(cc + 1), scale);
    const int b = (int)__fmul_rn(target, 1.0f / W) - BW / 2;
    return min(max(b, 0), ub);
  };

  uint32_t vp[BW], vn[BW];
  int sb[BW];
  int base = band_base(0);
#pragma unroll
  for (int w = 0; w < BW; ++w) {
    vp[w] = ONES; vn[w] = 0; sb[w] = base * W + (w + 1) * W;
  }

  for (int col = 0; col < P; ++col) {
    const uint32_t pmm = path[(size_t)col * R + r];
    const int nb = max(band_base(col), base);
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
      const int row_w = nb + w;
      uint32_t eq = 0;
      if (row_w < RW) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if ((pmm >> k) & 1u) eq |= planes[((size_t)k * RW + row_w) * R + r];
      }
      hin = advance(vp[w], vn[w], sb[w], eq, hin);
      const size_t o = ((size_t)col * BW + w) * R + r;
      dvp[o] = vp[w];
      dvn[o] = vn[w];
      dsb[o] = sb[w];
    }
    dbase[(size_t)col * R + r] = nb;
    base = nb;
  }
}

template <int BW>
cudaError_t launch(const uint32_t* planes, const uint32_t* path,
                   const int* read_len, const int* path_len, int R, int RW,
                   int P, uint32_t* dvp, uint32_t* dvn, int* dsb, int* dbase,
                   cudaStream_t stream) {
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  polish_core_kernel<BW><<<blocks, threads, 0, stream>>>(
      planes, path, read_len, path_len, R, RW, P, dvp, dvn, dsb, dbase);
  return cudaGetLastError();
}

}  // namespace

extern "C" int polish_core_launch(const void* planes, const void* path,
                                  const void* read_len, const void* path_len,
                                  int R, int RW, int P, int bw, void* dvp,
                                  void* dvn, void* dsb, void* dbase,
                                  void* stream) {
  if (R <= 0 || P <= 0) return 0;
  auto args = [&](auto launcher) {
    return launcher((const uint32_t*)planes, (const uint32_t*)path,
                    (const int*)read_len, (const int*)path_len, R, RW, P,
                    (uint32_t*)dvp, (uint32_t*)dvn, (int*)dsb, (int*)dbase,
                    (cudaStream_t)stream);
  };
  cudaError_t err;
  switch (bw) {
    case 1: err = args(launch<1>); break;
    case 2: err = args(launch<2>); break;
    case 4: err = args(launch<4>); break;
    case 8: err = args(launch<8>); break;
    case 16: err = args(launch<16>); break;
    case 32: err = args(launch<32>); break;
    case 64: err = args(launch<64>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
