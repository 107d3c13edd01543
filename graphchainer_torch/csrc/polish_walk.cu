// Score and backtrace walk over the polish fill's dump, packed for the host.
//
// Replaces: the XLA code graphchainer_tpu/ops/linear_align.py
// _score_from_dump_t + _backtrace_t + pack_ops2 (no Pallas kernel there);
// computes exactly graphchainer_torch/ops/linear_align.py _polish_walk_t.
// Per read: the global score at (read_len - 1, path_len - 1), then a walk
// from that cell back to (-1, -1), one step per edit op (ties: insertion,
// then diagonal, then deletion), failing when no neighbour explains the
// score, when the walk leaves the band, or at ops_cap steps; `touched`
// records whether it ran along a band edge with DP rows beyond it.  The
// 2-bit ops are packed on the fly, 16 per word, and written once a word
// fills; the padding past n_ops is all-ones, as pack_ops2 makes it from
// OP_NONE.  Row/word division that can see -1 is floor division.
//
// What bounds it on the H100: latency.  A walk is a chain of ~read + path
// dependent steps, each a few loads (three cells: diagonal, left, up) and
// ~100 instructions that one warp issues one after another; the bytes
// (the dump words the walk touches, read once) lie far below (PERF.md).
//
// Up to 64 band words, one warp per read (polish_walk_tile_kernel) over a
// read-major dump, [read][col][word], with the word stride ws = bw
// rounded up to a multiple of 4, as polish_core_launch and
// polish_core_any_launch write it.  The walk only moves to lower columns,
// so the warp stages the dump ahead of it: a tile is 33 columns (32 plus
// the column to the left, so a step's cells at cc and cc - 1 always share
// a tile) with every band word of vp / vn / sb, the band base and the path
// mask, copied with cp.async in 16-byte pieces into shared memory (a
// column is ws words, so it starts on 16 bytes whatever the width).  Two
// tiles alternate: the next lower one is in flight while the current one
// is walked, so a step's loads are shared-memory loads, and a tile holds
// whole columns, so a cell lies outside it only by column, never by word:
// BIGB means the band excludes the cell, nothing else.  A cell's three
// loads are issued together, from clamped places, with selects for the
// cases.  The read's plane word of the current row and the one below it
// sit in registers.  All lanes take the same steps (broadcast loads, no
// divergence); lane 0 writes the row, and all lanes write the padding.
// The band width is a run-time argument (polish_walk_any_launch, every
// width up to 64, the default ramp's 8, 16 and 32 too); the buffers are
// laid out by a stride class of 8, 16, 32 or 64 words, so the loads keep
// constant offsets, as they did in the template entries for 8, 16 and 32
// that this kernel replaced (PERF.md: 1.1-1.4% slower in turns).  Both
// buffers take 2 x 3,440 (class 8) to 2 x 25,616 bytes (class 64, past
// the 48 KB of static shared memory, so dynamic, with the block's limit
// raised).
//
// Past 64 band words (polish_walk_any_launch; only an explicit
// --polish-band above 64 reaches them), one thread per read
// (polish_walk_thread_kernel) over a column-major dump, [col][word][read],
// as the thread-per-read fill writes it: dump cells read straight from
// device memory, two chained loads a cell (base, then the word) at a
// stride of R words, coalesced across the warp's reads.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;
constexpr int BIGB = 1 << 26;
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr int OP_MATCH = 0, OP_DEL = 1, OP_INS = 2, OP_MISMATCH = 3;
constexpr int MAX_TILE_BW = 64;   // widest band the warp walk stages

__device__ __forceinline__ int floordiv32(int a) {   // floor(a / 32)
  return a >= 0 ? a / W : -((-a + W - 1) / W);
}

__device__ __forceinline__ uint32_t above(int rr) {  // bits above row rr % 32
  const int m = rr - floordiv32(rr) * W;
  return m < W - 1 ? (ONES << (m + 1)) : 0u;
}

__device__ __forceinline__ int word_score(int sb, uint32_t vp, uint32_t vn,
                                          int rr) {
  const uint32_t a = above(rr);
  return sb - __popc(vp & a) + __popc(vn & a);
}

// The dump in device memory, column-major.
struct GlobalDump {
  const uint32_t* vp;    // (P, bw, R)
  const uint32_t* vn;
  const int* sb;
  const int* base;       // (P, R)
  const uint32_t* path;  // (P, R)
  int P, bw, R, r;

  __device__ __forceinline__ int width() const { return bw; }
  __device__ __forceinline__ void seek(int) {}
  __device__ __forceinline__ int base_of(int cq) const {
    return base[(size_t)cq * R + r];
  }
  __device__ __forceinline__ uint32_t path_of(int cq) const {
    return path[(size_t)cq * R + r];
  }
  __device__ __forceinline__ int word(int cq, int w, int rr) const {
    const size_t o = ((size_t)cq * bw + w) * R + r;
    return word_score(sb[o], vp[o], vn[o], rr);
  }
  // DP cell (rr, cc), BIGB where the band of its column excludes it
  __device__ __forceinline__ int cell(int rr, int cc) const {
    if (rr < 0 && cc < 0) return 0;
    if (cc < 0) return rr + 1;
    if (rr < 0) return cc + 1;
    const int cq = min(cc, P - 1);
    const int w = floordiv32(rr) - base_of(cq);
    if (w < 0 || w >= bw) return BIGB;
    return word(cq, w, rr);
  }
};

// The dump staged in shared memory by a warp, read-major, two tiles of
// TILE + 1 columns, the band width taken at run time.  The dump's word stride
// `ws` is the band width rounded up to a multiple of 4, so every column
// starts on 16 bytes and a tile is a contiguous run of 16-byte pieces.
// A buffer holds vp, vn and sb as arrays of COLS x NS words, NS >= ws a
// compile-time stride class (8, 16, 32, 64), a column's words at a stride
// of ws in each, so a cell's three loads take constant offsets whatever
// the width.
constexpr int TILE = 32;

template <int NS>
struct TileDump {
  static constexpr int COLS = TILE + 1;
  struct __align__(16) Buf {     // cp.async moves 16-byte pieces
    uint32_t vp[COLS * NS];
    uint32_t vn[COLS * NS];
    int sb[COLS * NS];
    int base[COLS];
    uint32_t path[COLS];
  };
  Buf* buf;              // [2] in shared memory, 16-byte aligned
  const uint32_t* gvp;   // this read's (P, ws) planes of the dump
  const uint32_t* gvn;
  const int* gsb;
  const int* gbase;      // this read's (P,)
  const uint32_t* gpath; // (P, R) + r
  int P, bw, R, lane;
  int cur, tile, lo;     // buffer, tile index and first column walked now
  int lo_next;

  __device__ __forceinline__ int width() const { return bw; }
  __device__ __forceinline__ int ws() const { return (bw + 3) & ~3; }

  __device__ __forceinline__ static int first_col(int t) {
    return max(TILE * t - 1, 0);
  }

  // start the copy of tile t (columns TILE t - 1 .. TILE t + TILE - 1,
  // cut to 0 .. P - 1) into buffer b
  __device__ void fetch(int t, int b) {
    const int c0 = first_col(t);
    const int ncol = min(TILE * t + TILE - 1, P - 1) - c0 + 1;
    Buf& d = buf[b];
    const size_t g = (size_t)c0 * ws();
    for (int i = lane; i < ncol * ws() / 4; i += 32) {
      __pipeline_memcpy_async(&d.vp[4 * i], gvp + g + 4 * i, 16);
      __pipeline_memcpy_async(&d.vn[4 * i], gvn + g + 4 * i, 16);
      __pipeline_memcpy_async(&d.sb[4 * i], gsb + g + 4 * i, 16);
    }
    for (int i = lane; i < ncol; i += 32) {
      __pipeline_memcpy_async(&d.base[i], gbase + c0 + i, 4);
      __pipeline_memcpy_async(&d.path[i], gpath + (size_t)(c0 + i) * R, 4);
    }
    __pipeline_commit();
  }

  __device__ void open(int cq) {        // first tile: the one holding cq
    cur = 0;
    tile = cq / TILE;
    lo = first_col(tile);
    fetch(tile, 0);
    lo_next = lo;
    if (tile > 0) {
      lo_next = first_col(tile - 1);
      fetch(tile - 1, 1);
      __pipeline_wait_prior(1);         // the first tile has landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
  }

  // make column cq (and cq - 1) readable: the walk moved one tile down
  __device__ __forceinline__ void seek(int cq) {
    if (cq / TILE == tile) return;
    __pipeline_wait_prior(0);
    __syncwarp();                       // every lane's pieces have landed,
    cur ^= 1;                           // and no lane still reads the old
    tile -= 1;
    lo = lo_next;
    if (tile > 0) {
      lo_next = first_col(tile - 1);
      fetch(tile - 1, cur ^ 1);
    }
  }

  __device__ __forceinline__ int base_of(int cq) const {
    return buf[cur].base[cq - lo];
  }
  __device__ __forceinline__ uint32_t path_of(int cq) const {
    return buf[cur].path[cq - lo];
  }
  __device__ __forceinline__ int word(int cq, int w, int rr) const {
    const Buf& d = buf[cur];
    const int o = (cq - lo) * ws() + w;
    return word_score(d.sb[o], d.vp[o], d.vn[o], rr);
  }
  // DP cell (rr, cc), BIGB where the band of its column excludes it.
  // Without a branch: the loads go to clamped places and the cases are
  // selects, so the loads of a step's three cells are issued together
  // and their latencies overlap.
  __device__ __forceinline__ int cell(int rr, int cc) const {
    const Buf& d = buf[cur];
    const int j = min(max(min(cc, P - 1) - lo, 0), COLS - 1);
    const int rc = max(rr, 0);
    const int w = (rc >> 5) - d.base[j];
    const int o = j * ws() + min(max(w, 0), width() - 1);
    int v = word_score(d.sb[o], d.vp[o], d.vn[o], rc);
    v = (w < 0 || w >= width()) ? BIGB : v;
    v = rr < 0 ? cc + 1 : v;
    v = cc < 0 ? rr + 1 : v;
    return (rr < 0 && cc < 0) ? 0 : v;
  }
};

// The read's plane words of the walk's current row and of the word below.
struct ReadPlanes {
  const uint32_t* planes;   // (4, RW, R) + r
  int RW, R;
  int wq;                   // word held in cur (-1: none)
  uint32_t cur[4], next[4];

  __device__ __forceinline__ void load(int w, uint32_t (&dst)[4]) const {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[b] = w >= 0 ? planes[((size_t)b * RW + w) * R] : 0u;
  }
  // plane bits of row rq (0 <= rq < 32 RW), as a 4-bit mask
  __device__ __forceinline__ uint32_t bits(int rq) {
    const int w = rq / W;
    if (w != wq) {
      if (w == wq - 1) {
#pragma unroll
        for (int b = 0; b < 4; ++b) cur[b] = next[b];
      } else {
        load(w, cur);
      }
      wq = w;
      load(w - 1, next);
    }
    const int bit = rq % W;
    return ((cur[0] >> bit) & 1u) | (((cur[1] >> bit) & 1u) << 1)
           | (((cur[2] >> bit) & 1u) << 2) | (((cur[3] >> bit) & 1u) << 3);
  }
};

// One read's score and walk.  `writer` lanes store the row's first words
// and its ops; every lane of the `lanes` that run this together stores a
// share of the padding.
template <class Dump>
__device__ void walk(Dump& d, ReadPlanes& rp, int rl, int pl, int RW,
                     int max_steps, int ops_cap, long long* __restrict__ row,
                     bool writer, int lane, int lanes) {
  const int P = d.P, bw = d.width();
  const int n_words = ops_cap / 16;

  // global score: row rl - 1 at column pl - 1, word clamped into the band
  {
    const int last = min(max(pl - 1, 0), P - 1);
    const int rr = rl - 1;
    const int wofs = min(max(floordiv32(rr) - d.base_of(last), 0), bw - 1);
    const int score = d.word(last, wofs, rr);
    if (writer) row[0] = score;
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
    if (cc >= 0) d.seek(min(cc, P - 1));
    const int dg = d.cell(rr - 1, cc - 1);
    const int lf = d.cell(rr, cc - 1);
    const int up = d.cell(rr - 1, cc);
    int sub = 1;
    if (rr >= 0 && cc >= 0) {
      const uint32_t pm = d.path_of(min(cc, P - 1));
      sub = (rp.bits(min(rr, RW * W - 1)) & pm & 0xFu) ? 0 : 1;
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
      const int base_c = d.base_of(min(cc, P - 1));
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
    if (k % 16 == 0) {
      if (writer) row[3 + k / 16 - 1] = (long long)word;
      word = ONES;
    }
    done = rr < 0 && cc < 0;
  }
  int wi = k / 16;
  if (k % 16) {
    if (writer) row[3 + wi] = (long long)word;
    ++wi;
  }
  for (wi += lane; wi < n_words; wi += lanes) row[3 + wi] = (long long)ONES;
  if (writer) {
    const bool complete = done && !fail && rr < 0 && cc < 0;
    row[1] = complete ? k : -1;
    row[2] = touch ? 1 : 0;
  }
}

__global__ void __launch_bounds__(64)
polish_walk_thread_kernel(GlobalDump d,
                          const uint32_t* __restrict__ planes,  // (4, RW, R)
                          const int* __restrict__ read_len,
                          const int* __restrict__ path_len, int RW,
                          int max_steps, int ops_cap,
                          long long* __restrict__ out) {  // (R, 3 + cap / 16)
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= d.R) return;
  d.r = r;
  ReadPlanes rp{planes + r, RW, d.R, -1, {}, {}};
  walk(d, rp, read_len[r], path_len[r], RW, max_steps, ops_cap,
       out + (size_t)r * (3 + ops_cap / 16), true, 0, 1);
}

// A warp per read over a read-major dump of word stride ws <= NS, its two
// tile buffers in shared memory.
template <int NS>
__global__ void __launch_bounds__(32)
polish_walk_tile_kernel(const uint32_t* __restrict__ dvp,     // (R, P, ws)
                        const uint32_t* __restrict__ dvn,
                        const int* __restrict__ dsb,
                        const int* __restrict__ dbase,        // (R, P)
                        const uint32_t* __restrict__ planes,  // (4, RW, R)
                        const uint32_t* __restrict__ path,    // (P, R)
                        const int* __restrict__ read_len,
                        const int* __restrict__ path_len, int R, int RW,
                        int P, int bw, int max_steps, int ops_cap,
                        long long* __restrict__ out) {  // (R, 3 + cap / 16)
  // static shared memory where both buffers fit in 48 KB, else dynamic
  using Buf = typename TileDump<NS>::Buf;
  constexpr bool STATIC = 2 * sizeof(Buf) <= 48 * 1024;
  __shared__ __align__(16) unsigned char fixed[STATIC ? 2 * sizeof(Buf) : 16];
  extern __shared__ __align__(16) unsigned char dynamic[];
  Buf* const tiles = (Buf*)(STATIC ? fixed : dynamic);
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int ws = (bw + 3) & ~3;
  const size_t rp_off = (size_t)r * P;
  TileDump<NS> d{tiles, dvp + rp_off * ws, dvn + rp_off * ws,
                 dsb + rp_off * ws, dbase + rp_off, path + r, P, bw, R,
                 lane, 0, 0, 0, 0};
  const int rl = read_len[r];
  const int pl = path_len[r];
  d.open(min(max(pl - 1, 0), P - 1));
  ReadPlanes rp{planes + r, RW, R, -1, {}, {}};
  walk(d, rp, rl, pl, RW, max_steps, ops_cap,
       out + (size_t)r * (3 + ops_cap / 16), lane == 0, lane, 32);
}

struct WalkArgs {
  const uint32_t* dvp;
  const uint32_t* dvn;
  const int* dsb;
  const int* dbase;
  const uint32_t* planes;
  const uint32_t* path;
  const int* read_len;
  const int* path_len;
  int R, RW, P, bw, max_steps, ops_cap;
  long long* out;
  cudaStream_t stream;
};

template <int NS>
cudaError_t launch_tile(const WalkArgs& a) {
  const int size = 2 * (int)sizeof(typename TileDump<NS>::Buf);
  const int bytes = size <= 48 * 1024 ? 0 : size;
  if (bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        polish_walk_tile_kernel<NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  polish_walk_tile_kernel<NS><<<a.R, 32, bytes, a.stream>>>(
      a.dvp, a.dvn, a.dsb, a.dbase, a.planes, a.path, a.read_len,
      a.path_len, a.R, a.RW, a.P, a.bw, a.max_steps, a.ops_cap, a.out);
  return cudaGetLastError();
}

bool bad_sizes(int P, int bw, int ops_cap) {
  return P <= 0 || bw <= 0 || ops_cap <= 0 || ops_cap % 16;
}

}  // namespace

// Any bw >= 1.  Up to MAX_TILE_BW words a warp per read over a read-major
// dump of word stride ws = bw rounded up to a multiple of 4: dvp / dvn /
// dsb (R, P, ws), dbase (R, P).  Past it a thread per read over a
// column-major dump: dvp / dvn / dsb (P, bw, R), dbase (P, R).
extern "C" int polish_walk_any_launch(const void* dvp, const void* dvn,
                                      const void* dsb, const void* dbase,
                                      const void* planes, const void* path,
                                      const void* read_len,
                                      const void* path_len, int R, int RW,
                                      int P, int bw, int max_steps,
                                      int ops_cap, void* out, void* stream) {
  if (R <= 0) return 0;
  if (bad_sizes(P, bw, ops_cap)) return (int)cudaErrorInvalidValue;
  if (bw <= MAX_TILE_BW) {
    const WalkArgs a{(const uint32_t*)dvp, (const uint32_t*)dvn,
                     (const int*)dsb, (const int*)dbase,
                     (const uint32_t*)planes, (const uint32_t*)path,
                     (const int*)read_len, (const int*)path_len, R, RW, P,
                     bw, max_steps, ops_cap, (long long*)out,
                     (cudaStream_t)stream};
    return (int)(bw <= 8    ? launch_tile<8>(a)
                 : bw <= 16 ? launch_tile<16>(a)
                 : bw <= 32 ? launch_tile<32>(a)
                            : launch_tile<64>(a));
  }
  GlobalDump d{(const uint32_t*)dvp, (const uint32_t*)dvn, (const int*)dsb,
               (const int*)dbase, (const uint32_t*)path, P, bw, R, 0};
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  polish_walk_thread_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      d, (const uint32_t*)planes, (const int*)read_len,
      (const int*)path_len, RW, max_steps, ops_cap, (long long*)out);
  return (int)cudaGetLastError();
}
