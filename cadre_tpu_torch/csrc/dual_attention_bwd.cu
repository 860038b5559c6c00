// Backward of the fused position (PAM) and channel (CAM) attention of the
// DANet head, f32, one block per branch and batch row.
//
// Replaces: no TPU kernel. The JAX package differentiates the plain
// cadre_tpu/ops/dual_attention.py::pam_apply / cam_apply with XLA's
// autodiff; this is the gradient of the forward kernel
// (csrc/dual_attention.cu), written from the math. Per batch row, with
// v, x_c, dy_p, dy_c: [P, C] and q, k: [P, D]:
//   PAM, E = q k^T, A = softmax_rows(E), O = A v, y = gp O + x_p:
//     G = dy_p v^T [P, P];  dgp = sum(A * G);  dA = gp G;
//     dv = gp A^T dy_p;  dE = A * (dA - rowsum(dA * A));
//     dq = dE k;  dk = dE^T q;  dx_p = dy_p (the wrapper passes dy_p on).
//   CAM, G = x^T x [C, C], Bm = softmax_rows(rowmax(G) - G), O = x Bm^T,
//   y = gc O + x:
//     H = dy^T x [C, C];  dgc = sum(Bm * H);  dB = gc H;
//     dN = Bm * (dB - rowsum(dB * Bm));
//     dx_c = dy + gc dy Bm - x (dN + dN^T).
//   The rowmax shift has no gradient (a softmax row is shift-invariant).
// A and Bm are recomputed from the inputs, not saved by the forward.
//
// What bounds it on an H100: operations. At the trainer's shapes (P = 40,
// C = 128, D = 16) a row reads six [P, C] or [P, D] tensors and writes four
// (about 0.13 MB a row in f32) but needs about 5.6 MFLOP, 4.6 of them in
// the CAM branch's C x C x P products (the symmetric Gram x^T x counted
// once per pair): at B = 48, 0.27 GFLOP against 6.4 MB, about 4.0 us at
// 67 TFLOP/s of f32 FMA against 1.9 us at 3.35 TB/s.
//
// Design (first version: simple and right before fast): a grid of
// (2, B) blocks of 512 threads; block 0 of a row does CAM, block 1 PAM.
// Each block copies its row's operands into shared memory once and runs
// every product there as f32 FMA chains on the CUDA cores (TF32 would
// break the f32 tolerances), a thread holding a 4 x 4 register tile of the
// output whose columns are 16 apart, so that a warp reads 16 neighbouring
// words of the right operand per step; operands read along a column are
// stored with an odd row stride, free of bank conflicts. Row softmaxes and
// the row sums of the chain rule run one warp per row, in registers. The
// CAM block keeps Bm and dN, two C x C f32 matrices (64 KB each at
// C = 128), beside x and dy: 169 KB, above the 48 KB a block gets without
// opting in, so the first launch on a device opts in once for the largest
// shape the wrapper allows (193 KB of the H100's 227 KB) and one block
// fits an SM. The CAM block is the row's long pole (2.6 M FMA against
// PAM's 0.5 M); splitting it needs the full dN, so across blocks it needs
// a cluster or a second pass, which a later version can add.
// The gamma gradients sum B * P * C terms. Each block reduces its row in a
// fixed order (per warp by shuffles, then the warps in order) and writes
// one value per row; the wrapper sums the B values, so the result does
// not change from run to run (no atomics).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 128;       // limits the wrapper enforces
constexpr int kMaxP = 64;
constexpr int kMaxD = 32;

__host__ __device__ inline size_t cam_bytes(int P, int C) {
  return (2 * static_cast<size_t>(P) * C + 2 * static_cast<size_t>(C) * (C + 1)) *
         sizeof(float);
}
__host__ __device__ inline size_t pam_bytes(int P, int C, int D) {
  return (static_cast<size_t>(P) * D + static_cast<size_t>(P) * (D + 1) +
          static_cast<size_t>(P) * (C + 1) + static_cast<size_t>(P) * C +
          2 * static_cast<size_t>(P) * (P + 1)) *
         sizeof(float);
}
size_t smem_bytes(int P, int C, int D) {
  const size_t a = cam_bytes(P, C), b = pam_bytes(P, C, D);
  return a > b ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy a [rows, cols] row-major array from global memory into shared
// memory with row stride ld.
__device__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                          int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    dst[(i / cols) * ld + i % cols] = src[i];
  }
}

// The 4 x 4 tile of one thread in smem_gemm: rows m0 + 16 i, columns
// n0 + 16 j, each index clamped into range for the loads (the products of
// a clamped index are computed and never stored).
struct Tile {
  int m[4], n[4];
  bool mv[4], nv[4];
  __device__ Tile(int item, int tn, int M, int N) {
    const int tile = item >> 8, local = item & 255;
    const int m0 = (tile / tn) * 64 + (local >> 4);
    const int n0 = (tile % tn) * 64 + (local & 15);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = m0 + 16 * i;
      n[i] = n0 + 16 * i;
      mv[i] = m[i] < M;
      nv[i] = n[i] < N;
      if (!mv[i]) m[i] = 0;
      if (!nv[i]) n[i] = 0;
    }
  }
};

// out(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, over k < K in order,
// with A(m, k) = a[m * am + k * ak] and B(k, n) = b[k * bk + n * bn] in
// shared memory; calls store(m, n, out(m, n)) once for each output.
template <class Store>
__device__ void smem_gemm(const float* a, int am, int ak, const float* b,
                          int bk, int bn, int M, int N, int K, Store store) {
  const int tm = (M + 63) / 64, tn = (N + 63) / 64;
  for (int item = threadIdx.x; item < tm * tn * 256; item += blockDim.x) {
    const Tile t(item, tn, M, N);
    float acc[4][4] = {};
    for (int kk = 0; kk < K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[t.m[i] * am + kk * ak];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b[kk * bk + t.n[j] * bn];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t.mv[i] && t.nv[j]) store(t.m[i], t.n[j], acc[i][j]);
  }
}

// Two products of one output shape and depth at once: A1 B1 and A2 B2,
// with A(m, k) = a[m * am + k] and B(k, n) = b[k * bk + n] for both;
// calls store(m, n, (A1 B1)(m, n), (A2 B2)(m, n)).
template <class Store>
__device__ void smem_gemm2(const float* a1, const float* b1, const float* a2,
                           const float* b2, int am, int bk, int M, int N,
                           int K, Store store) {
  const int tm = (M + 63) / 64, tn = (N + 63) / 64;
  for (int item = threadIdx.x; item < tm * tn * 256; item += blockDim.x) {
    const Tile t(item, tn, M, N);
    float acc1[4][4] = {}, acc2[4][4] = {};
    for (int kk = 0; kk < K; ++kk) {
      float x1[4], y1[4], x2[4], y2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x1[i] = a1[t.m[i] * am + kk];
        x2[i] = a2[t.m[i] * am + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y1[j] = b1[kk * bk + t.n[j]];
        y2[j] = b2[kk * bk + t.n[j]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(x1[i], y1[j], acc1[i][j]);
          acc2[i][j] = fmaf(x2[i], y2[j], acc2[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t.mv[i] && t.nv[j])
          store(t.m[i], t.n[j], acc1[i][j], acc2[i][j]);
  }
}

// Sum of each thread's `v` over the block in a fixed order (shuffles per
// warp, then the warps in order); the result is valid in thread 0.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += red[w];
  }
  return s;
}

// CAM of one batch row: dx_c and this row's share of dgc.
__device__ void cam_block(const float* __restrict__ x,
                          const float* __restrict__ dy, float g,
                          float* __restrict__ dx, float* __restrict__ dg,
                          int P, int C, float* sm, float* red) {
  const int ldc = C + 1;
  float* xs = sm;                      // [P][C]
  float* dys = xs + P * C;             // [P][C]
  float* bm = dys + P * C;             // [C][C + 1]: G, then Bm
  float* sn = bm + C * ldc;            // [C][C + 1]: H, then dN, then S
  load_rows(xs, C, x, P, C);
  load_rows(dys, C, dy, P, C);
  __syncthreads();
  // G = x^T x and H = dy^T x
  smem_gemm(xs, 1, C, xs, C, 1, C, C, P,
            [&](int i, int j, float v) { bm[i * ldc + j] = v; });
  smem_gemm(dys, 1, C, xs, C, 1, C, C, P,
            [&](int i, int j, float v) { sn[i * ldc + j] = v; });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = kMaxC / 32;
  float dg_part = 0.0f;
  for (int i = warp; i < C; i += kWarps) {
    float* grow = bm + i * ldc;
    float* hrow = sn + i * ldc;
    float n[kPer];
    float gmax = -INFINITY;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int j = lane + 32 * s;
      if (j < C) gmax = fmaxf(gmax, grow[j]);
    }
    gmax = warp_max(gmax);
    float nmax = -INFINITY;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int j = lane + 32 * s;
      n[s] = j < C ? gmax - grow[j] : -INFINITY;
      nmax = fmaxf(nmax, n[s]);
    }
    nmax = warp_max(nmax);
    float sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int j = lane + 32 * s;
      n[s] = j < C ? expf(n[s] - nmax) : 0.0f;
      sum += n[s];
    }
    sum = warp_sum(sum);
    float h[kPer], dot = 0.0f;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int j = lane + 32 * s;
      n[s] = n[s] / sum;                       // Bm[i][j]
      h[s] = j < C ? hrow[j] : 0.0f;
      dg_part = fmaf(n[s], h[s], dg_part);
      dot = fmaf(g * h[s], n[s], dot);
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int j = lane + 32 * s;
      if (j < C) {
        grow[j] = n[s];
        hrow[j] = n[s] * (g * h[s] - dot);     // dN[i][j]
      }
    }
  }
  __syncthreads();
  // S = dN + dN^T, in place: each unordered pair (i, j) belongs to one
  // thread
  for (int idx = threadIdx.x; idx < C * C; idx += blockDim.x) {
    const int i = idx / C, j = idx % C;
    if (i < j) {
      const float s = sn[i * ldc + j] + sn[j * ldc + i];
      sn[i * ldc + j] = s;
      sn[j * ldc + i] = s;
    } else if (i == j) {
      sn[i * ldc + i] += sn[i * ldc + i];
    }
  }
  __syncthreads();
  // dx = dy + g (dy Bm) - x S
  smem_gemm2(dys, bm, xs, sn, C, ldc, P, C, C,
             [&](int p, int j, float v1, float v2) {
               dx[p * C + j] = dys[p * C + j] + g * v1 - v2;
             });
  const float total = block_sum(dg_part, red);
  if (threadIdx.x == 0) *dg = total;
}

// PAM of one batch row: dq, dk, dv and this row's share of dgp.
__device__ void pam_block(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dy, float g,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ dg,
                          int P, int C, int D, float* sm, float* red) {
  const int ldk = D + 1, ldv = C + 1, lda = P + 1;
  float* qs = sm;                      // [P][D]
  float* ks = qs + P * D;              // [P][D + 1]
  float* vs = ks + P * ldk;            // [P][C + 1]
  float* dys = vs + P * ldv;           // [P][C]
  float* as = dys + P * C;             // [P][P + 1]: E, then A
  float* gs = as + P * lda;            // [P][P + 1]: G, then dE
  load_rows(qs, D, q, P, D);
  load_rows(ks, ldk, k, P, D);
  load_rows(vs, ldv, v, P, C);
  load_rows(dys, C, dy, P, C);
  __syncthreads();
  // E = q k^T and G = dy v^T
  smem_gemm(qs, D, 1, ks, 1, ldk, P, P, D,
            [&](int p, int r, float e) { as[p * lda + r] = e; });
  smem_gemm(dys, C, 1, vs, 1, ldv, P, P, C,
            [&](int p, int r, float e) { gs[p * lda + r] = e; });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kPer = kMaxP / 32;
  float dg_part = 0.0f;
  for (int p = warp; p < P; p += kWarps) {
    float* arow = as + p * lda;
    float* grow = gs + p * lda;
    float e[kPer];
    float emax = -INFINITY;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      e[s] = r < P ? arow[r] : -INFINITY;
      emax = fmaxf(emax, e[s]);
    }
    emax = warp_max(emax);
    float sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      e[s] = r < P ? expf(e[s] - emax) : 0.0f;
      sum += e[s];
    }
    sum = warp_sum(sum);
    float gr[kPer], dot = 0.0f;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      e[s] = e[s] / sum;                       // A[p][r]
      gr[s] = r < P ? grow[r] : 0.0f;
      dg_part = fmaf(e[s], gr[s], dg_part);
      dot = fmaf(g * gr[s], e[s], dot);
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      if (r < P) {
        arow[r] = e[s];
        grow[r] = e[s] * (g * gr[s] - dot);    // dE[p][r]
      }
    }
  }
  __syncthreads();
  // dv = g A^T dy, dq = dE k, dk = dE^T q
  smem_gemm(as, 1, lda, dys, C, 1, P, C, P,
            [&](int r, int c, float s) { dv[r * C + c] = g * s; });
  smem_gemm(gs, lda, 1, ks, ldk, 1, P, D, P,
            [&](int p, int d, float s) { dq[p * D + d] = s; });
  smem_gemm(gs, 1, lda, qs, D, 1, P, D, P,
            [&](int r, int d, float s) { dk[r * D + d] = s; });
  const float total = block_sum(dg_part, red);
  if (threadIdx.x == 0) *dg = total;
}

// Block (0, b) does CAM of row b, block (1, b) PAM of row b.
__global__ void __launch_bounds__(kThreads, 1)
dual_attention_bwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ gp,
                          const float* __restrict__ xc,
                          const float* __restrict__ gc,
                          const float* __restrict__ dyp,
                          const float* __restrict__ dyc,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ dxc,
                          float* __restrict__ dgamma, int B, int P, int C,
                          int D) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  const int b = blockIdx.y;
  const size_t ov = static_cast<size_t>(b) * P * C;
  const size_t oq = static_cast<size_t>(b) * P * D;
  if (blockIdx.x == 0) {
    cam_block(xc + ov, dyc + ov, gc[0], dxc + ov, dgamma + B + b, P, C, sm,
              red);
  } else {
    pam_block(q + oq, k + oq, v + ov, dyp + ov, gp[0], dq + oq, dk + oq,
              dv + ov, dgamma + b, P, C, D, sm, red);
  }
}

// Opts the kernel in to the dynamic shared memory of the largest shape the
// wrapper allows, once per device (the attribute is the device's, so later
// launches there skip the host call).
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(dual_attention_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxP, kMaxC, kMaxD)));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace

// q, k, dq, dk: [B, P, D]; v, x_cam, dy_pam, dy_cam, dv, dx_cam: [B, P, C];
// gamma_pam, gamma_cam: [1]; all f32, contiguous, on the device.
// dgamma: [2, B] f32; row 0 gets each batch row's share of dgamma_pam, row
// 1 of dgamma_cam. 1 <= P <= 64, C a multiple of 32 up to 128,
// 1 <= D <= 32 (the wrapper checks). Returns cudaGetLastError() (or the
// error of the shared-memory opt-in).
extern "C" int dual_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* gamma_pam,
    const void* x_cam, const void* gamma_cam, const void* dy_pam,
    const void* dy_cam, void* dq, void* dk, void* dv, void* dx_cam,
    void* dgamma, int B, int P, int C, int D, void* stream) {
  if (P > kMaxP || C > kMaxC || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(P, C, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dual_attention_bwd_kernel<<<dim3(2, B), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(gamma_pam),
      static_cast<const float*>(x_cam), static_cast<const float*>(gamma_cam),
      static_cast<const float*>(dy_pam), static_cast<const float*>(dy_cam),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dx_cam),
      static_cast<float*>(dgamma), B, P, C, D);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one block uses, which chip_smoke.py
// reports beside the kernel's times.
extern "C" long long dual_attention_bwd_smem_bytes(int P, int C, int D) {
  return static_cast<long long>(smem_bytes(P, C, D));
}
