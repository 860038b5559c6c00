// Shape-table painter for the device env's two canvases (route figure and
// camera), batched over envs, with a per-tile cull of the table.
//
// Replaces: cadre_tpu/ops/paint.py::_paint_pallas (kernel body
// _paint_kernel), which holds one [H, W, C] canvas in VMEM and walks an
// [S, 8] table of rows (kind, a, b, c, d, r, g, b) in order, last writer
// wins:
//   kind 0 (rect): hit = a <= x < b  and  c <= y < d
//   kind 1 (disk): hit = (x - a)^2 + (y - b)^2 <= c
//
// What bounds it on an H100: bytes. The function has to read the base
// canvas once, write the painted canvas once and read the table; at the
// main path's shapes (N = 32, route figure 256 x 144 x 1 from 103 rows,
// camera 144 x 256 x 3 from 140 rows) that is 37.99 MB per env step, about
// 0.011 ms at 3.35 TB/s. The row tests are not part of the bound: how many
// a design makes is its own choice.
//
// What the first design lost: every pixel tested every row of its env's
// table, five shared-memory loads and a compare chain per (pixel, row).
// On the main path most rows miss most tiles (the route ribbon is 7.5 px
// disks along one curve; masked rows are empty rects or have r2 = -1), so
// nearly all of that work was wasted.
//
// Design: one block per (env, 32 x 8 pixel tile), one pixel per thread.
// The block first culls the env's table for its tile: each thread reads
// one row (two 16-byte loads) and tests it against the tile; a warp ballot
// and a prefix sum over the warps compact the survivors, in table order,
// into a list in shared memory. Tables longer than the block are culled in
// chunks of kThreads rows, each chunk appended after the last. Then every
// pixel walks only the survivors, keeps its colour in registers and writes
// it once. Rows stay in table order inside each thread, which is the
// "last writer wins" contract; blocks share nothing. The channels go out
// as scalar stores: neighbouring threads hold neighbouring pixels, so a
// warp's stores cover one contiguous run (128 B of the route figure, 384 B
// of the camera) and coalesce; 16-byte stores would need several pixels
// per thread and a wider tile, which keeps more rows per tile.
//
// The cull is conservative: it keeps every row that hits a pixel of the
// tile [x0, x1] x [y0, y1] (it may keep one that misses).
// - Rect: kept iff a < b, c < d, a <= x1, b > x0, c <= y1 and d > y0. A
//   hit at (x, y) gives a <= x <= x1, b > x >= x0 and the same in y, with
//   the pixel test's own comparisons. a < b and c < d drop the masked
//   rows, which are empty rects (b = a).
// - Disk: kept iff the pixel test itself, in the same rounded arithmetic,
//   passes at the tile point nearest the centre, (clamp(a, x0, x1),
//   clamp(b, y0, y1)). For any pixel x of the tile, |x - a| >= |nx - a|
//   exactly; round-to-nearest is monotone, so |fl(x - a)| >=
//   |fl(nx - a)|, then fl(dx * dx) is not smaller, and so the rounded sum;
//   if the pixel's sum is <= r2, so is the nearest point's. That is the
//   exact disk-rectangle test and needs no margin for rounding, unlike a
//   bounding box [a - R, a + R] built from a rounded sqrt(r2). Masked disks
//   (r2 = -1) and the far masked centres (-1e6) fail it, as does any NaN.
//
// Exactness: the disk test must match the plain PyTorch version bit for
// bit, so it is written with __fsub_rn/__fmul_rn/__fadd_rn, which nvcc
// never contracts into an FMA; the cull uses the same function.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;

// One table row: geo = (kind, a, b, c), col = (d, r, g, b).
struct __align__(16) Row {
  float4 geo;
  float4 col;
};

__device__ __forceinline__ float dist2(float x, float y, float a, float b) {
  const float dx = __fsub_rn(x, a);
  const float dy = __fsub_rn(y, b);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ bool is_rect(const Row& r) { return r.geo.x < 0.5f; }

__device__ __forceinline__ bool hits(const Row& r, float x, float y) {
  if (is_rect(r)) {
    return (x >= r.geo.y) & (x < r.geo.z) & (y >= r.geo.w) & (y < r.col.x);
  }
  return dist2(x, y, r.geo.y, r.geo.z) <= r.geo.w;
}

// False only if no pixel of [x0, x1] x [y0, y1] hits the row (see above).
__device__ __forceinline__ bool may_hit(const Row& r, float x0, float x1,
                                        float y0, float y1) {
  if (is_rect(r)) {
    const float a = r.geo.y, b = r.geo.z, c = r.geo.w, d = r.col.x;
    return (a < b) & (c < d) & (a <= x1) & (b > x0) & (c <= y1) & (d > y0);
  }
  const float nx = fminf(fmaxf(r.geo.y, x0), x1);
  const float ny = fminf(fmaxf(r.geo.z, y0), y1);
  return dist2(nx, ny, r.geo.y, r.geo.z) <= r.geo.w;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
paint_kernel(const float* __restrict__ base, const Row* __restrict__ shapes,
             float* __restrict__ out, int h, int w, int s) {
  extern __shared__ Row list[];                 // survivors, table order
  __shared__ int warp_count[kWarps];
  const int env = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px0 = blockIdx.x * kTileW;
  const int py0 = blockIdx.y * kTileH;
  const float x0 = static_cast<float>(px0);
  const float x1 = static_cast<float>(min(px0 + kTileW, w) - 1);
  const float y0 = static_cast<float>(py0);
  const float y1 = static_cast<float>(min(py0 + kTileH, h) - 1);
  const Row* rows = shapes + static_cast<size_t>(env) * s;

  int count = 0;
  for (int r0 = 0; r0 < s; r0 += kThreads) {
    Row row;
    bool keep = false;
    if (r0 + tid < s) {
      row = rows[r0 + tid];
      keep = may_hit(row, x0, x1, y0, y1);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = count + __popc(ballot & ((1u << lane) - 1u));
    int total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int n = warp_count[i];
      pos += i < warp ? n : 0;
      total += n;
    }
    if (keep) list[pos] = row;
    count += total;
    __syncthreads();  // list is complete; warp_count may be rewritten
  }

  const int px = px0 + tid % kTileW;
  const int py = py0 + tid / kTileW;
  if (px >= w || py >= h) return;
  const float xx = static_cast<float>(px);
  const float yy = static_cast<float>(py);
  const size_t off = ((static_cast<size_t>(env) * h + py) * w + px) * C;

  float col[C];
#pragma unroll
  for (int j = 0; j < C; ++j) col[j] = base[off + j];
  for (int i = 0; i < count; ++i) {
    const Row r = list[i];
    if (hits(r, xx, yy)) {
      const float rgb[3] = {r.col.y, r.col.z, r.col.w};
#pragma unroll
      for (int j = 0; j < C; ++j) col[j] = rgb[j];
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) out[off + j] = col[j];
}

template <int C>
int launch(const void* base, const void* shapes, void* out, int n, int h,
           int w, int s, void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  const size_t smem = static_cast<size_t>(s) * sizeof(Row);
  paint_kernel<C><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const Row*>(shapes),
      static_cast<float*>(out), h, w, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// base, out: [n, h, w, c] f32 contiguous; shapes: [n, s, 8] f32 contiguous
// and 16-byte aligned; 1 <= c <= 3 (a row carries three colours);
// s <= 1535, so that the table (32 B a row) and the 32 B of warp_count fit
// the 48 KB of shared memory a block has without opting in. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a channel count the
// kernel does not take.
extern "C" int paint_f32(const void* base, const void* shapes, void* out,
                         int n, int h, int w, int c, int s, void* stream) {
  switch (c) {
    case 1: return launch<1>(base, shapes, out, n, h, w, s, stream);
    case 2: return launch<2>(base, shapes, out, n, h, w, s, stream);
    case 3: return launch<3>(base, shapes, out, n, h, w, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
