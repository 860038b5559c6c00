// Shape-table painter for the device env's two canvases (route figure and
// camera), batched over envs.
//
// Replaces: cadre_tpu/ops/paint.py::_paint_pallas (kernel body
// _paint_kernel), which holds one [H, W, C] canvas in VMEM and walks an
// [S, 8] table of rows (kind, a, b, c, d, r, g, b) in order, last writer
// wins:
//   kind 0 (rect): hit = a <= x < b  and  c <= y < d
//   kind 1 (disk): hit = (x - a)^2 + (y - b)^2 <= c
//
// What bounds it on an H100: each pixel is read once and written once
// (bytes), and every pixel tests every row (operations, about ten fp32
// operations per test). At the main path's shapes the row tests dominate:
// 36,864 pixels x 140 rows per camera canvas.
//
// Design: one block per (env, tile of 256 pixels). The env's table is
// staged once in shared memory (140 x 8 x 4 B = 4.5 KB for the camera), so
// the row loop reads it as a broadcast; each thread owns one pixel, keeps
// its colour in registers across the whole table, and writes it once.
// No atomics and no ordering between blocks: rows are applied in order
// inside each thread, which is the "last writer wins" contract.
//
// Exactness: the disk test must match the plain PyTorch version bit for
// bit, so it is written with __fsub_rn/__fmul_rn/__fadd_rn, which nvcc
// never contracts into an FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

__global__ void paint_kernel(const float* __restrict__ base,
                             const float* __restrict__ shapes,
                             float* __restrict__ out,
                             int h, int w, int c, int s) {
  extern __shared__ float table[];
  const int env = blockIdx.y;
  const float* env_shapes = shapes + static_cast<size_t>(env) * s * 8;
  for (int i = threadIdx.x; i < s * 8; i += blockDim.x) {
    table[i] = env_shapes[i];
  }
  __syncthreads();

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  const float xx = static_cast<float>(pix % w);
  const float yy = static_cast<float>(pix / w);
  const size_t off = (static_cast<size_t>(env) * h * w + pix) * c;

  float col[kMaxChannels];
  for (int j = 0; j < c; ++j) col[j] = base[off + j];

  for (int r = 0; r < s; ++r) {
    const float* row = table + r * 8;
    bool hit;
    if (row[0] < 0.5f) {
      hit = (xx >= row[1]) & (xx < row[2]) & (yy >= row[3]) & (yy < row[4]);
    } else {
      const float dx = __fsub_rn(xx, row[1]);
      const float dy = __fsub_rn(yy, row[2]);
      hit = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= row[3];
    }
    if (hit) {
      for (int j = 0; j < c; ++j) col[j] = row[5 + j];
    }
  }
  for (int j = 0; j < c; ++j) out[off + j] = col[j];
}

}  // namespace

// base, out: [n, h, w, c] f32 contiguous; shapes: [n, s, 8] f32 contiguous.
// c <= 3 (a row carries three colours). Returns cudaGetLastError().
extern "C" int paint_f32(const void* base, const void* shapes, void* out,
                         int n, int h, int w, int c, int s, void* stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  const size_t smem = static_cast<size_t>(s) * 8 * sizeof(float);
  paint_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const float*>(shapes),
      static_cast<float*>(out), h, w, c, s);
  return static_cast<int>(cudaGetLastError());
}
