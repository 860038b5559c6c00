// Fused position (PAM) and channel (CAM) attention of the DANet head,
// several blocks per batch row, products on the tensor cores.
//
// Replaces: cadre_tpu/ops/pallas_dual_attention.py::dual_attention_pallas
// (kernel body _fused_kernel). Per batch row, with x, v: [P, C] and
// q, k: [P, D]:
//   PAM: att = softmax_k(q k^T);              y = gp * (att v) + x
//   CAM: E = x^T x; att = softmax_j(rowmax(E) - E);
//                                             y = gc * (x att^T) + x
// Inputs are f32 or bf16; every product is accumulated in f32, the two
// attention matrices are rounded to the input type before they are applied
// (as the TPU kernel and the XLA path do), and the gamma residual is added
// in f32 and rounded once, as the TPU kernel does. It takes every head the
// JAX package builds on any camera: any P >= 1 positions, C a multiple of
// 32 up to 512 (a resnet50-152 backbone's 2048 channels / 4), D <= 64
// (C / 8). No block's shared memory or registers grow with P.
//
// What bounds it on an H100: at the main path's shapes (P = 40, C = 128,
// D = 16, bf16) bytes: a row reads three [P, C] and two [P, D] tensors and
// writes two [P, C] ones, 53.8 KB in bf16, against 3.1 MFLOP: about 0.5 us
// at B = 32 and 4 us at B = 256. A row's CAM is C^2 P multiply-adds for
// 3 C P values, so at C = 512 in f32 the operations bound it (0.024 ms at
// B = 48, P = 40 as f32 FMA at 67 TFLOP/s), and its PAM is P^2 C for the
// same bytes, so a large camera (P = 475 at 800x600) is bound by
// operations too. In bf16 the exact-rounding contract below keeps the
// energies and the gram on the CUDA cores, so the bf16 kernel's floor
// there is those FMA chains (C^2 P + 3 P^2 D a row at 33.5 TFMA/s), not
// the tensor cores.
//
// Design: a batch row is split over independent blocks of 256 threads
// (the wide PAM blocks 512 past C = 256), which need no communication:
// - CAM block g (C / 32 of them) computes rows i0 = 32 g .. i0 + 31 of the
//   gram, their row softmax, and from them columns i0 .. i0 + 31 of the CAM
//   output.
// - A PAM block computes att v for a range of queries (and, in the narrow
//   kernel, a range of columns).
// Two kernels take that split. The narrow one (C <= 128, P <= 64: the
// main path's resnet18/34 heads at 144x256) holds a whole row's x, the
// [P, P] scores and the gram rows at their largest in registers and
// shared memory, one launch with both kinds of block, and stays as it was
// measured: wide code at those shapes ran 4% (f32) to 12% (bf16) slower
// (H100 80GB HBM3, 700 W). The wide one takes the rest, any P, in two
// launches side by side: the PAM launch forked from the caller's stream
// onto a second one and joined back (fork.cuh), each with its own
// registers and shared memory. Issued one after the other on the
// caller's stream instead, the P = 144 rows ran 20% (f32) and 34% (bf16)
// slower and P = 475, C = 128 2-7% (same card, chip_smoke.py
// --kernel-times; C = 512, P = 475 within 1%).
// - its CAM blocks stream the positions through shared memory in tiles
//   (all of P in one tile up to 64 positions; past that 64 or 32 rows a
//   tile, two tiles in flight: cp.async brings in the next tile while the
//   current one is multiplied); the gram pass walks the tiles forward, the
//   apply pass backward, so the last tile is read once;
// - its PAM blocks (dual_attention_pam_tiles) take a 64-query tile each
//   over all C value columns (256 threads up to C = 256, 512 past it, 64
//   accumulators a thread), so that each energy is formed once per walk
//   and not once per column range. Its key tiles (64 keys) sit transposed
//   in shared memory as f32 and each thread forms a 4 x 4 (or 2 x 4)
//   register tile of q k^T whose operands are two vector loads a step.
//   bf16: three walks, the max, the sum of exp(e - max) in the plain
//   version's warp order (each tile's exps staged in shared memory, lane l
//   of a row's warp adding keys l, l + 32, ... in order), then att =
//   exp(e - max) / sum rounded to bf16 and applied; f32: two walks, the
//   first keeping each thread's running max and sum (fast exp; the f32
//   attention is not rounded, so neither the order of the sum nor exp's
//   last bits matter). The value tiles (32 or 64 keys) come two stages
//   deep by cp.async and the applies run on the tensor cores, each warp
//   owning 32 query rows and a C / 4 or C / 8 column range. Up to P = 64
//   this is one block per batch row; the earlier PAM blocks there (up to
//   128 columns each, in the CAM blocks' grid, the energies formed again
//   for each column range) ran 3-24% slower at C = 512, P = 40 (same card,
//   --kernel-times) and went.
// bf16: the products that apply an attention matrix (att v and x att^T)
// are warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate), exactly the
// TPU kernel's contract. Their K dimension is padded with zeros in shared
// memory (P = 40 -> 48), which leaves every sum unchanged; M is padded to
// 16 and the padded rows are never stored; padded keys get probability 0,
// and the attention goes into the product as bf16, the rounding the
// contract asks for. The products that make the energies (q k^T and x^T x)
// stay on the CUDA cores as chains of f32 FMAs in position (or d) order,
// the order of the plain version's f32 products, and the softmax's sum
// runs in the plain version's warp order, so that the rounded attention is
// the plain version's bit for bit. Rounding is where the bound is: the
// attention is rounded to bf16, and an energy or a sum that differs in its
// last f32 bits (a tensor-core sum rounds in another order and way) flips
// that rounding at some weights, which moves an output by up to a bf16
// step of its largest term, many steps of a small output where terms
// cancel. With all four products on the tensor cores the kernel was 8.9
// bf16 ulps from the plain version at B = 256 (H100 80GB HBM3, 700 W;
// chip_smoke.py's bound is 4); tests/test_torch_port_deep_head.py holds a
// reordered f32 energy or gram (16-term exact chunks, as a tensor core
// sums) to more than 4 ulps at the 800x600 shapes. v enters as stored,
// row-major, through ldmatrix.trans.
// f32: the narrow kernel's products run on the CUDA cores; the wide
// kernel's gram and both applies run on the tensor cores in 3xTF32
// (mma_tf32.cuh: plain TF32 would break the f32 tolerances, 3xTF32 is as
// accurate as f32 FMA at these sums); its energies q k^T are f32 FMA
// chains (D <= 64 deep, a small share of the work beside C-wide applies).
// mma.sync rather than wgmma and TMA: a CAM block's gram is 32 rows, below
// wgmma's 64-row warpgroup tile, and the applies are 16 to 64 rows by 32
// to 128 columns a warp, where the block is bound by its latency and not
// by the tensor-core rate; row strides are padded so that the fragment
// loads are free of bank conflicts, or nearly.
// A warp holds whole rows of an energy in its registers (the wide PAM
// blocks stage them), so each row's softmax runs there with warp shuffles
// and only the rounded attention goes to shared memory.
// Shared memory per block at the main path's shapes: 21 KB in bf16, 36 KB
// in f32 (the first design: 116 KB), so several blocks share an SM; in the
// wide kernel's CAM blocks at most about 100 KB in bf16 and 198 KB in f32
// (C = 512), whatever P, opted in per launch above 48 KB; its PAM blocks
// at most 111 KB (bf16) and 186 KB (f32). The CAM blocks run two an SM
// (128 registers; 207 held one) but for f32 past C = 128, whose tiles
// hold an SM alone.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py --kernel-times,
// graph ms at B = 48): P = 475 f32 C = 128 0.2236, bf16 0.1984, f32 C = 512
// 1.6073, bf16 1.1575 (bound by operations: the bf16 energies and gram's
// f32 FMA chains, the f32 gram and applies in 3xTF32); P = 144 f32 0.0517,
// bf16 0.0461; C = 512, P = 40 f32 0.1593, bf16 0.1065. More in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fork.cuh"
#include "mma_tf32.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using mma3::View;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;       // channels (CAM) or value columns (PAM)
constexpr int kNarrowC = 128;    // what the narrow kernel takes
constexpr int kNarrowP = 64;
constexpr int kMaxC = 512;       // limits the wrapper enforces
constexpr int kMaxD = 64;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// ------------------------------------------------------- shared layouts
// Byte sizes of each block's regions, in the order they are carved out.

__host__ __device__ inline size_t cam_bf16_xr(int P, int C) {
  return align16(static_cast<size_t>(round16(P)) * (C + 8) * 2);
}
__host__ __device__ inline size_t cam_bf16_bytes(int P, int C) {
  return cam_bf16_xr(P, C) + align16(static_cast<size_t>(kGroup) * (C + 8) * 2);
}
__host__ __device__ inline size_t pam_bf16_q(int P, int D) {
  return align16(static_cast<size_t>(P) * D * 2);
}
__host__ __device__ inline size_t pam_bf16_k(int P, int D) {
  return align16(static_cast<size_t>(P) * (D + 1) * 2);
}
__host__ __device__ inline size_t pam_bf16_v(int P, int C) {
  return align16(static_cast<size_t>(round16(P)) * (C + 8) * 2);
}
__host__ __device__ inline size_t pam_bf16_bytes(int P, int C, int D) {
  const int kp = round16(P);
  return pam_bf16_q(P, D) + pam_bf16_k(P, D) + pam_bf16_v(P, C) +
         align16(static_cast<size_t>(kp) * (kp + 8) * 2);
}
__host__ __device__ inline size_t f32_region(int rows, int cols) {
  return align16(static_cast<size_t>(rows) * cols * 4);
}
__host__ __device__ inline size_t cam_f32_bytes(int P, int C) {
  return f32_region(P, C) + f32_region(kGroup, C + 1);
}
__host__ __device__ inline size_t pam_f32_bytes(int P, int C, int D) {
  return f32_region(P, D) + f32_region(P, D + 1) + f32_region(P, C) +
         f32_region(P, P + 1);
}

template <typename T> size_t smem_bytes(int P, int C, int D);
template <> size_t smem_bytes<float>(int P, int C, int D) {
  const size_t a = cam_f32_bytes(P, C), b = pam_f32_bytes(P, C, D);
  return a > b ? a : b;
}
template <> size_t smem_bytes<bf16>(int P, int C, int D) {
  const size_t a = cam_bf16_bytes(P, C), b = pam_bf16_bytes(P, C, D);
  return a > b ? a : b;
}

// The wide kernel's CAM position tile's row stride past C, per input
// type.
template <typename T> struct Wide;
template <> struct Wide<bf16> {
  static constexpr int kPadX = 8;
};
template <> struct Wide<float> {
  static constexpr int kPadX = 4;
};

// Rows of a CAM tile: all of P in one tile up to 64 positions, else
// tile_rows in two buffers (a tile of x is at most 33 KB in bf16 and
// 66 KB in f32, so that two of them and the gram rows stay near 100 KB,
// or, for f32 at C > 256, within one block an SM).
template <typename T> int tile_rows(int C);
template <> int tile_rows<bf16>(int C) { return C <= 256 ? 64 : 32; }
template <> int tile_rows<float>(int C) { return C <= 128 ? 64 : 32; }

__host__ __device__ inline int cam_bufs(int P) { return P <= 64 ? 1 : 2; }

template <typename T>
__host__ __device__ inline size_t wide_cam_tile(int tp, int C) {
  return align16(static_cast<size_t>(round16(tp)) * (C + Wide<T>::kPadX) *
                 sizeof(T));
}
template <typename T>
__host__ __device__ inline size_t wide_cam_bytes(int P, int tp, int C) {
  return cam_bufs(P) * wide_cam_tile<T>(tp, C) +
         align16(static_cast<size_t>(kGroup) * (C + Wide<T>::kPadX) *
                 sizeof(T));
}

// ------------------------------------------------------- helpers

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint4* z = static_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads) {
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc[i][j] += sum_k a(m, k) b(k, n) at m = w + W i (warp w of W) and
// n = l + 32 j (lane l), zero where m >= M or n >= N, on the CUDA cores.
// Each sum is one
// chain of f32 FMAs over k = 0, 1, ... (continued from acc): the order of
// the plain version's f32 products (cuBLAS), so that both round the same
// sums. a(m, k) is a broadcast within the warp, and b(k, n) walks
// neighbouring addresses when its column stride is 1 (or odd). A warp
// holds whole rows of acc.
template <int RM, int RN, class FA, class FB>
__device__ __forceinline__ void gemm_f32_acc(int M, int N, int K, FA a, FB b,
                                             float (&acc)[RM][RN]) {
  const int tm = threadIdx.x >> 5, tn = threadIdx.x & 31;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = tm + kWarps * i;
      av[i] = m < M ? a(m, kk) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = tn + 32 * j;
      bv[j] = n < N ? b(kk, n) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}
template <int RM, int RN>
__device__ __forceinline__ void zero_acc(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}
// acc = a b, as gemm_f32_acc from zero.
template <int RM, int RN, class FA, class FB>
__device__ __forceinline__ void gemm_f32(int M, int N, int K, FA a, FB b,
                                         float (&acc)[RM][RN]) {
  zero_acc(acc);
  gemm_f32_acc(M, N, K, a, b, acc);
}

// Softmax of one row held by a warp in registers, lane l holding columns
// l, l + 32, ... in v; columns >= n_valid are masked (probability 0). With
// `cam` the row is first replaced by rowmax(row) - row. Writes out[0 .. n)
// in OutT. The reductions run in the order of PyTorch's warp softmax: each
// lane over its columns in order, then a butterfly over the lanes.
template <int N, typename OutT>
__device__ __forceinline__ void softmax_row(float (&v)[N], int n_valid, int n,
                                            bool cam, OutT* out, int lane) {
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (lane + 32 * u >= n_valid) v[u] = -INFINITY;
    m = fmaxf(m, v[u]);
  }
  m = warp_max(m);
  if (cam) {
    float m2 = -INFINITY;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (lane + 32 * u < n_valid) {
        v[u] = m - v[u];
        m2 = fmaxf(m2, v[u]);
      }
    }
    m = warp_max(m2);
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    v[u] = lane + 32 * u < n_valid ? expf(v[u] - m) : 0.f;
    s += v[u];
  }
  s = warp_sum(s);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int j = lane + 32 * u;
    if (j < n) store(out + j, v[u] / s);
  }
}

// ------------------------------------------------------- tensor cores

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[16 x 8] = A[16 x K] B[K x 8], A row-major in shared memory
// (K contiguous, K a multiple of 16). B is stored transposed, [8][K] with K
// contiguous, or with kRowB row-major, [K][8] with its 8 columns
// contiguous, and then read with ldmatrix.trans, which hands each lane the
// two neighbouring k of one column that the fragment wants. Lane l holds
// acc[0..1] at (l / 4, 2 (l % 4) + {0, 1}) and acc[2..3] 8 rows below.
template <bool kRowB>
__device__ __forceinline__ void warp_mma(float (&acc)[4], const bf16* A,
                                         int lda, const bf16* B, int ldb,
                                         int K, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* a = A + g * lda + 2 * t;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  for (int k = 0; k < K; k += 16) {
    const uint32_t af[4] = {ld_pair(a + k), ld_pair(a + 8 * lda + k),
                            ld_pair(a + k + 8), ld_pair(a + 8 * lda + k + 8)};
    uint32_t bfr[2];
    if constexpr (kRowB) {
      // lanes 0-15 address rows k .. k + 15 of the two 8 x 8 tiles
      const unsigned addr = static_cast<unsigned>(
          __cvta_generic_to_shared(B + (k + (lane & 15)) * ldb));
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(bfr[0]), "=r"(bfr[1])
          : "r"(addr));
    } else {
      const bf16* b = B + g * ldb + 2 * t;
      bfr[0] = ld_pair(b + k);
      bfr[1] = ld_pair(b + k + 8);
    }
    mma_bf16(acc, af, bfr);
  }
}

// out[p, col0 + n] = g * (A B)[p, n] + res[p, col0 + n] for p < P and
// n < ncols (a multiple of 8), with A [Kp x K] and B as in warp_mma, by the
// block's warps on m16n8 tiles; res and out rows are ldr and C apart.
// Two neighbouring columns per store.
template <bool kRowB>
__device__ __forceinline__ void apply_bf16(const bf16* A, int lda,
                                           const bf16* B, int ldb, int K,
                                           int kp, int ncols, int P, float g,
                                           const bf16* res, int ldr,
                                           bf16* out, int C, int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g4 = lane >> 2, t2 = 2 * (lane & 3);
  const int ntiles = ncols / 8;
  for (int tile = warp; tile < (kp / 16) * ntiles; tile += kWarps) {
    const int m0 = (tile / ntiles) * 16, n0 = (tile % ntiles) * 8;
    float acc[4];
    warp_mma<kRowB>(acc, A + m0 * lda, lda, B + (kRowB ? n0 : n0 * ldb), ldb,
                    K, lane);
    const int col = col0 + n0 + t2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g4 + 8 * h;
      if (p < P) {
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(res + p * ldr + col);
        *reinterpret_cast<__nv_bfloat162*>(out + p * C + col) =
            __floats2bfloat162_rn(g * acc[2 * h] + __low2float(r),
                                  g * acc[2 * h + 1] + __high2float(r));
      }
    }
  }
}

// ------------------------------------------------------- narrow bf16 blocks

// CAM columns i0 .. i0 + 31 of one batch row; x, out: [P, C].
__device__ void cam_block(const bf16* __restrict__ x, float g,
                          bf16* __restrict__ out, int P, int C, int i0,
                          unsigned char* sm) {
  const int kp = round16(P);
  const int ldx = C + 8;                  // x and att rows
  bf16* xr = reinterpret_cast<bf16*>(sm);
  bf16* att = reinterpret_cast<bf16*>(sm + cam_bf16_xr(P, C));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  zero_smem(xr + P * ldx, static_cast<size_t>(kp - P) * ldx * 2);
  for (int i = tid; i < (C / 8) * P; i += kThreads) {
    const int p = i / (C / 8), c8 = i % (C / 8);
    *reinterpret_cast<uint4*>(xr + p * ldx + c8 * 8) =
        *reinterpret_cast<const uint4*>(x + p * C + c8 * 8);
  }
  __syncthreads();

  // gram rows i0 + 8 w .. i0 + 8 w + 7 (warp w), E[i, j] = sum_p x[p, i]
  // x[p, j] at j = l + 32 u (lane l), as chains of f32 FMAs over p in order
  // (see gemm_f32), then their softmax in the registers of the warp
  constexpr int kRows = kGroup / kWarps;
  float e[kRows][kNarrowC / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int u = 0; u < kNarrowC / 32; ++u) e[r][u] = 0.f;
  const bf16* rows = xr + i0 + kRows * warp;
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    __nv_bfloat162 a[kRows / 2];
#pragma unroll
    for (int r = 0; r < kRows / 2; ++r) {
      a[r] = reinterpret_cast<const __nv_bfloat162*>(rows + p * ldx)[r];
    }
    float bv[kNarrowC / 32];
#pragma unroll
    for (int u = 0; u < kNarrowC / 32; ++u) {
      const int j = lane + 32 * u;
      bv[u] = j < C ? __bfloat162float(xr[p * ldx + j]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = r % 2 ? __high2float(a[r / 2]) : __low2float(a[r / 2]);
#pragma unroll
      for (int u = 0; u < kNarrowC / 32; ++u) e[r][u] = fmaf(av, bv[u], e[r][u]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    softmax_row(e[r], C, C, true, att + (kRows * warp + r) * ldx, lane);
  }
  __syncthreads();

  // y[p, i0 + i] = g * sum_j x[p, j] att[i, j] + x[p, i0 + i]
  apply_bf16<false>(xr, ldx, att, ldx, C, kp, kGroup, P, g, xr, ldx, out, C,
                    i0);
}

// PAM columns c0 .. c0 + nc - 1 of one batch row; x, v, out: [P, C];
// q, k: [P, D].
__device__ void pam_block(const bf16* __restrict__ x,
                          const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, float g,
                          bf16* __restrict__ out, int P, int C, int D, int c0,
                          int nc, unsigned char* sm) {
  const int kp = round16(P);
  const int ldk = D + 1;                  // k rows
  const int ldv = nc + 8;                 // v rows
  const int lda = kp + 8;                 // att rows
  bf16* qs = reinterpret_cast<bf16*>(sm);
  unsigned char* next = sm + pam_bf16_q(P, D);
  bf16* ks = reinterpret_cast<bf16*>(next);
  next += pam_bf16_k(P, D);
  bf16* vs = reinterpret_cast<bf16*>(next);
  bf16* att = reinterpret_cast<bf16*>(next + pam_bf16_v(P, C));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // padded keys of v and padded query rows of att are zero
  zero_smem(vs + P * ldv, static_cast<size_t>(kp - P) * ldv * 2);
  zero_smem(att + P * lda, static_cast<size_t>(kp - P) * lda * 2);
  for (int i = tid; i < P * D; i += kThreads) {
    qs[i] = q[i];
    ks[(i / D) * ldk + i % D] = k[i];
  }
  for (int i = tid; i < (nc / 8) * P; i += kThreads) {
    const int key = i / (nc / 8), c8 = i % (nc / 8);
    *reinterpret_cast<uint4*>(vs + key * ldv + c8 * 8) =
        *reinterpret_cast<const uint4*>(v + key * C + c0 + c8 * 8);
  }
  __syncthreads();

  // energy [P, P] = q k^T and its softmax in registers; padded keys get
  // probability 0
  float s[kNarrowP / kWarps][kNarrowP / 32];
  gemm_f32(
      P, P, D, [&](int p, int d) { return __bfloat162float(qs[p * D + d]); },
      [&](int d, int key) { return __bfloat162float(ks[key * ldk + d]); }, s);
#pragma unroll
  for (int i = 0; i < kNarrowP / kWarps; ++i) {
    const int row = warp + kWarps * i;
    if (row < P) softmax_row(s[i], P, kp, false, att + row * lda, lane);
  }
  __syncthreads();

  // y[p, c0 + c] = g * sum_key att[p, key] v[key, c0 + c] + x[p, c0 + c]
  apply_bf16<true>(att, lda, vs, ldv, kp, kp, nc, P, g, x, C, out, C, c0);
}

// ------------------------------------------------------- narrow f32 blocks

__device__ void cam_block(const float* __restrict__ x, float g,
                          float* __restrict__ out, int P, int C, int i0,
                          unsigned char* sm) {
  const int lda = C + 1;
  float* xs = reinterpret_cast<float*>(sm);                      // [P, C]
  float* att = reinterpret_cast<float*>(sm + f32_region(P, C));  // [32, C + 1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < P * C / 4; i += kThreads) {
    reinterpret_cast<float4*>(xs)[i] = reinterpret_cast<const float4*>(x)[i];
  }
  __syncthreads();
  float e[kGroup / kWarps][kNarrowC / 32];
  gemm_f32(kGroup, C, P, [&](int m, int p) { return xs[p * C + i0 + m]; },
           [&](int p, int n) { return xs[p * C + n]; }, e);
#pragma unroll
  for (int i = 0; i < kGroup / kWarps; ++i) {
    softmax_row(e[i], C, C, true, att + (warp + kWarps * i) * lda, lane);
  }
  __syncthreads();
  float y[kNarrowP / kWarps][1];
  gemm_f32(P, kGroup, C, [&](int p, int j) { return xs[p * C + j]; },
           [&](int j, int i) { return att[i * lda + j]; }, y);
#pragma unroll
  for (int i = 0; i < kNarrowP / kWarps; ++i) {
    const int p = warp + kWarps * i;
    if (p < P) {
      out[p * C + i0 + lane] = g * y[i][0] + xs[p * C + i0 + lane];
    }
  }
}

__device__ void pam_block(const float* __restrict__ x,
                          const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float g,
                          float* __restrict__ out, int P, int C, int D,
                          int c0, int nc, unsigned char* sm) {
  const int ldk = D + 1;
  const int lda = P + 1;
  float* qs = reinterpret_cast<float*>(sm);                  // [P, D]
  unsigned char* next = sm + f32_region(P, D);
  float* ks = reinterpret_cast<float*>(next);                // [P, D + 1]
  next += f32_region(P, ldk);
  float* vs = reinterpret_cast<float*>(next);                // [P, C]
  float* att = reinterpret_cast<float*>(next + f32_region(P, C));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < P * D; i += kThreads) {
    qs[i] = q[i];
    ks[(i / D) * ldk + i % D] = k[i];
  }
  for (int i = tid; i < P * C / 4; i += kThreads) {
    reinterpret_cast<float4*>(vs)[i] = reinterpret_cast<const float4*>(v)[i];
  }
  __syncthreads();
  float s[kNarrowP / kWarps][kNarrowP / 32];
  gemm_f32(P, P, D, [&](int p, int d) { return qs[p * D + d]; },
           [&](int d, int key) { return ks[key * ldk + d]; }, s);
#pragma unroll
  for (int i = 0; i < kNarrowP / kWarps; ++i) {
    const int row = warp + kWarps * i;
    if (row < P) softmax_row(s[i], P, P, false, att + row * lda, lane);
  }
  __syncthreads();
  for (int cg = c0; cg < c0 + nc; cg += kGroup) {
    float y[kNarrowP / kWarps][1];
    gemm_f32(P, kGroup, P, [&](int p, int key) { return att[p * lda + key]; },
             [&](int key, int c) { return vs[key * C + cg + c]; }, y);
#pragma unroll
    for (int i = 0; i < kNarrowP / kWarps; ++i) {
      const int p = warp + kWarps * i;
      if (p < P) {
        out[p * C + cg + lane] = g * y[i][0] + x[p * C + cg + lane];
      }
    }
  }
}

// ------------------------------------------------------- wide blocks

// Rows [p0, p0 + np) of x [P, C] into a tile with row stride ld, 16 bytes
// a copy (cp.async), committed as one group.
template <typename T>
__device__ __forceinline__ void issue_tile(T* dst, int ld,
                                           const T* __restrict__ x, int p0,
                                           int np, int C) {
  mma3::load_rows16(dst, ld, x + static_cast<size_t>(p0) * C, np, C, C, 0,
                    kThreads);
  mma3::cp_commit();
}

// The gram rows of a CAM block: in bf16 chains of f32 FMAs in position
// order, a warp holding 8 whole rows (lane l: columns l + 32 u); in f32 in
// 3xTF32 on the tensor cores, a warp holding both 16-row m-tiles of
// C / 64 n-tiles (or fewer) of 8 columns.
template <typename T, int MC> struct CamGram;

template <int MC> struct CamGram<bf16, MC> {
  static constexpr int kRows = kGroup / kWarps;
  float e[kRows][MC / 32];

  __device__ void zero() { zero_acc(e); }
  // rows i0 + 8 w .. i0 + 8 w + 7 (warp w), E[i, j] += sum_p x[p, i]
  // x[p, j] at j = l + 32 u (lane l), over the np rows of the tile xr
  __device__ void add(const bf16* xr, int ldx, int np, int C, int i0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bf16* rows = xr + i0 + kRows * warp;
#pragma unroll 4
    for (int p = 0; p < np; ++p) {
      __nv_bfloat162 a[kRows / 2];
#pragma unroll
      for (int r = 0; r < kRows / 2; ++r) {
        a[r] = reinterpret_cast<const __nv_bfloat162*>(rows + p * ldx)[r];
      }
      float bv[MC / 32];
#pragma unroll
      for (int u = 0; u < MC / 32; ++u) {
        const int j = lane + 32 * u;
        bv[u] = j < C ? __bfloat162float(xr[p * ldx + j]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = r % 2 ? __high2float(a[r / 2]) : __low2float(a[r / 2]);
#pragma unroll
        for (int u = 0; u < MC / 32; ++u) e[r][u] = fmaf(av, bv[u], e[r][u]);
      }
    }
  }
  // each row's softmax of rowmax - E, rounded to bf16, into att
  __device__ void softmax(bf16* att, int lda, int C) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      softmax_row(e[r], C, C, true, att + (kRows * warp + r) * lda, lane);
    }
    __syncthreads();
  }
};

template <int MC> struct CamGram<float, MC> {
  static constexpr int kNT = MC / 64;
  float acc[2][kNT][4];
  int n0t, nt;                       // this warp's n-tiles

  __device__ void zero() {
    mma3::zero(acc);
  }
  __device__ void span(int C) {
    const int ntt = C / 8, per = (ntt + kWarps - 1) / kWarps;
    n0t = (threadIdx.x >> 5) * per;
    nt = min(per, ntt - n0t);
  }
  // G[i, n] += sum_p x[p, i0 + i] x[p, n] over the np rows of the tile xs
  __device__ void add(const float* xs, int ldx, int np, int C, int i0) {
    span(C);
    if (nt <= 0) return;
    const View a = View{xs + i0, 1, ldx, kGroup};
    mma3::warp_mma3<2, kNT>(acc, {a, a}, {0, 16}, 2, View{xs, 1, ldx, C},
                            8 * n0t, np, nt);
  }
  // G into att (f32, row stride lda), then each row's softmax of
  // rowmax - G in place
  __device__ void softmax(float* att, int lda, int C) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    span(C);
    if (nt > 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma3::store_tile(acc[mi], 16 * mi, 8 * n0t, kGroup, 8 * (n0t + nt),
                         [&](int m, int n, float v) { att[m * lda + n] = v; });
      }
    }
    __syncthreads();
    constexpr int kRows = kGroup / kWarps;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float* row = att + (kRows * warp + r) * lda;
      float e[MC / 32];
#pragma unroll
      for (int u = 0; u < MC / 32; ++u) {
        const int j = lane + 32 * u;
        e[u] = j < C ? row[j] : 0.f;
      }
      softmax_row(e, C, C, true, row, lane);
    }
    __syncthreads();
  }
};

// y[p0 + p, i0 + i] = g * sum_j x[p, j] att[i, j] + x[p, i0 + i] for the
// np rows of one tile
__device__ __forceinline__ void cam_apply_tile(const bf16* xr, int ldx,
                                               const bf16* att, int np,
                                               int C, float g, bf16* out,
                                               int i0) {
  apply_bf16<false>(xr, ldx, att, ldx, C, round16(np), kGroup, np, g, xr, ldx,
                    out, C, i0);
}
__device__ __forceinline__ void cam_apply_tile(const float* xs, int ldx,
                                               const float* att, int np,
                                               int C, float g, float* out,
                                               int i0) {
  const int warp = threadIdx.x >> 5;
  const int mt = (np + 15) / 16;
  auto put = [&](int p, int i, float v) {
    out[static_cast<size_t>(p) * C + i0 + i] = g * v + xs[p * ldx + i0 + i];
  };
  const View a = View{xs, ldx, 1, np}, b = View{att, ldx, 1, kGroup};
  if (mt > 2) {
    // up to 4 m-tiles x 4 n-tiles: 2 n-tiles a warp
    const int mi = warp >> 1, n0 = 16 * (warp & 1);
    if (mi >= mt) return;
    float acc[1][2][4];
    mma3::zero(acc);
    mma3::warp_mma3(acc, {a}, {16 * mi}, 1, b, n0, C);
    mma3::store_tile(acc[0], 16 * mi, n0, np, kGroup, put);
  } else {
    // up to 2 m-tiles x 4 n-tiles: one a warp
    const int mi = warp >> 2, n0 = 8 * (warp & 3);
    if (mi >= mt) return;
    float acc[1][1][4];
    mma3::zero(acc);
    mma3::warp_mma3(acc, {a}, {16 * mi}, 1, b, n0, C);
    mma3::store_tile(acc[0], 16 * mi, n0, np, kGroup, put);
  }
}

// CAM columns i0 .. i0 + 31 of one batch row; x, out: [P, C]; positions in
// tiles of tp rows, two tiles in flight past one.
template <typename T, int MC>
__device__ void cam_wide(const T* __restrict__ x, float g,
                          T* __restrict__ out, int P, int C, int i0, int tp,
                          unsigned char* sm) {
  const int ldx = C + Wide<T>::kPadX;     // x and att rows
  const int ntiles = (P + tp - 1) / tp;
  T* buf[2];
  buf[0] = reinterpret_cast<T*>(sm);
  buf[1] = cam_bufs(P) > 1
               ? reinterpret_cast<T*>(sm + wide_cam_tile<T>(tp, C))
               : buf[0];
  T* att = reinterpret_cast<T*>(sm + cam_bufs(P) * wide_cam_tile<T>(tp, C));
  auto rows = [&](int t) { return min(tp, P - t * tp); };

  // the gram pass, tiles forward, the next one loading meanwhile
  CamGram<T, MC> gram;
  gram.zero();
  issue_tile(buf[0], ldx, x, 0, rows(0), C);
  for (int t = 0; t < ntiles; ++t) {
    mma3::cp_wait<0>();
    __syncthreads();                      // tile t is in; t - 1 is read
    if (t + 1 < ntiles) {
      issue_tile(buf[(t + 1) & 1], ldx, x, (t + 1) * tp, rows(t + 1), C);
    }
    gram.add(buf[t & 1], ldx, rows(t), C, i0);
  }
  gram.softmax(att, ldx, C);

  // the apply pass, tiles backward: the last is still in its buffer
  for (int t = ntiles - 1; t >= 0; --t) {
    if (t < ntiles - 1) {
      mma3::cp_wait<0>();
      __syncthreads();                    // tile t is in; t + 1 is applied
    }
    if (t > 0) issue_tile(buf[(t - 1) & 1], ldx, x, (t - 1) * tp, rows(t - 1), C);
    cam_apply_tile(buf[t & 1], ldx, att, rows(t), C, g,
                   out + static_cast<size_t>(t) * tp * C, i0);
  }
}

// ------------------------------------------------------- wide PAM blocks
//
// A block of NTH threads per query tile of kTileQ = 64 rows over all C
// value columns (NTH = 256 up to C = 256, 512 past it: 64 accumulators a
// thread), so that each energy is formed once per walk and not once per
// column range. Keys come in energy tiles of kKE = 64: q and the key tile
// sit transposed in shared memory as f32, and thread (ty, tx) = (tid / 16,
// tid % 16) forms rows RM ty .. RM ty + RM - 1 (RM = 64 * 16 / NTH) of
// keys 4 tx .. 4 tx + 3 as chains of f32 FMAs over d in order, the plain
// version's f32 product (bf16 products are exact), a register tile whose
// loads are two vectors a step. bf16 walks the key tiles three times: the
// rows' max; the sum of exp(e - max) in the plain version's softmax order
// (each tile's exps staged in shared memory, lane l of a row's warp adding
// the keys l, l + 32, ... in order); then att = exp(e - max) / sum,
// rounded to bf16 into the attention tile and applied; so the rounded
// attention is the plain version's bit for bit, as in the narrow kernel.
// f32 walks twice (the max and sum at once, see walk 1). The value tiles
// (vk keys) come two stages deep by cp.async and are applied on the tensor
// cores (bf16 mma.sync m16n8k16, f32 3xTF32), each warp owning 32 query
// rows and a C / 4 (256 threads) or C / 8 (512) column range.

constexpr int kKE = 64;          // keys of an energy tile
constexpr int kLdk = kKE + 4;    // the key tile's and the exps' row stride

constexpr int kTileQ = 64;       // query rows of a tiled PAM block
template <typename T>
__host__ __device__ inline int pam_vk(int C) {
  return sizeof(T) == 2 && C <= 256 ? 64 : 32;
}
template <typename T>
__host__ __device__ inline int pam_lda() {
  return sizeof(T) == 2 ? kKE + 8 : kKE + 4;
}
// Regions: q^T [D][QT + 4] and the key tile [D][kLdk] (f32), the rows'
// max and sum, the attention tile [QT][lda], and two value stages [vk][C +
// 8], whose room the exps [QT][kLdk] (f32) share in the sum walk.
template <typename T>
__host__ __device__ inline size_t tiles_v_bytes(int C) {
  const size_t v = 2 * align16(static_cast<size_t>(pam_vk<T>(C)) * (C + 8) *
                               sizeof(T));
  const size_t e = align16(static_cast<size_t>(kTileQ) * kLdk * 4);
  return v > e ? v : e;
}
template <typename T>
__host__ __device__ inline size_t tiles_bytes(int C, int D) {
  const int qt = kTileQ;
  return align16(static_cast<size_t>(D) * (qt + 4) * 4) +
         align16(static_cast<size_t>(D) * kLdk * 4) +
         align16(static_cast<size_t>(2) * qt * 4) +
         align16(static_cast<size_t>(qt) * pam_lda<T>() * sizeof(T)) +
         tiles_v_bytes<T>(C);
}

// energies e = q k^T of thread (ty, tx)'s RM x 4 tile (see above)
template <int RM>
__device__ __forceinline__ void tile_energies(float (&e)[RM][4],
                                              const float* qs, int ldq,
                                              const float* ks, int D) {
  const float* qp = qs + RM * (threadIdx.x >> 4);
  const float* kp = ks + 4 * (threadIdx.x & 15);
#pragma unroll
  for (int i = 0; i < RM; ++i) e[i][0] = e[i][1] = e[i][2] = e[i][3] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 kv = *reinterpret_cast<const float4*>(kp + d * kLdk);
    float qv[RM];
    if constexpr (RM == 4) {
      const float4 t = *reinterpret_cast<const float4*>(qp + d * ldq);
      qv[0] = t.x, qv[1] = t.y, qv[2] = t.z, qv[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(qp + d * ldq);
      qv[0] = t.x, qv[1] = t.y;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      e[i][0] = fmaf(qv[i], kv.x, e[i][0]);
      e[i][1] = fmaf(qv[i], kv.y, e[i][1]);
      e[i][2] = fmaf(qv[i], kv.z, e[i][2]);
      e[i][3] = fmaf(qv[i], kv.w, e[i][3]);
    }
  }
}

// A warp's two m16 row tiles of a bf16 product, acc[i][j] += A[16 i ..,
// K] B[K, 8 j ..] for j < nt: A row-major (lda), B row-major [K][ldb]
// through ldmatrix.trans (each B fragment feeds both row tiles); K a
// multiple of 16.
template <int NT>
__device__ __forceinline__ void mma_rows2_bf16(float (&acc)[2][NT][4],
                                               const bf16* A, int lda,
                                               const bf16* B, int ldb, int K,
                                               int nt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* a0 = A + g * lda + 2 * t;
  const bf16* a1 = a0 + 16 * lda;
  for (int k = 0; k < K; k += 16) {
    const uint32_t f0[4] = {ld_pair(a0 + k), ld_pair(a0 + 8 * lda + k),
                            ld_pair(a0 + k + 8), ld_pair(a0 + 8 * lda + k + 8)};
    const uint32_t f1[4] = {ld_pair(a1 + k), ld_pair(a1 + 8 * lda + k),
                            ld_pair(a1 + k + 8), ld_pair(a1 + 8 * lda + k + 8)};
    const unsigned row = static_cast<unsigned>(
        __cvta_generic_to_shared(B + (k + (lane & 15)) * ldb));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      uint32_t bfr[2];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(bfr[0]), "=r"(bfr[1])
          : "r"(row + 16u * j));
      mma_bf16(acc[0][j], f0, bfr);
      mma_bf16(acc[1][j], f1, bfr);
    }
  }
}

// PAM of query rows q0 .. q0 + QT - 1 (fewer at the end) and all C value
// columns of one batch row; x, v, out: [P, C]; q, k: [P, D]. NT: the most
// n-tiles of 8 columns a warp holds.
template <typename T, int QT, int NT, int NTH>
__device__ void pam_tiles(const T* __restrict__ x, const T* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          float g, T* __restrict__ out, int P, int C, int D,
                          int q0, unsigned char* sm) {
  constexpr int kW = NTH / 32;          // warps
  constexpr int RM = QT * 16 / NTH, kRows = QT / kW;
  constexpr int kStage = kKE * kMaxD / NTH;
  constexpr int WM = QT / 32, WN = kW / WM;
  const int nq = min(QT, P - q0), nkt = (P + kKE - 1) / kKE;
  const int vk = pam_vk<T>(C), nsub = (P + vk - 1) / vk, per = kKE / vk;
  const int ldq = QT + 4, lda = pam_lda<T>(), ldv = C + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  float* qs = reinterpret_cast<float*>(sm);
  unsigned char* next = sm + align16(static_cast<size_t>(D) * ldq * 4);
  float* ks = reinterpret_cast<float*>(next);
  next += align16(static_cast<size_t>(D) * kLdk * 4);
  float* rowm = reinterpret_cast<float*>(next);
  float* rowl = rowm + QT;
  next += align16(static_cast<size_t>(2) * QT * 4);
  T* att = reinterpret_cast<T*>(next);
  next += align16(static_cast<size_t>(QT) * lda * sizeof(T));
  T* vs = reinterpret_cast<T*>(next);   // two stages; the exps in walk 2
  float* ps = reinterpret_cast<float*>(next);
  const size_t vstage = align16(static_cast<size_t>(vk) * ldv * sizeof(T)) /
                        sizeof(T);
  auto keys = [&](int t) { return min(kKE, P - t * kKE); };

  // q^T, rows past nq zero
  for (int i = tid; i < QT * D; i += NTH) {
    const int r = i / D, d = i % D;
    qs[d * ldq + r] =
        r < nq ? to_f32(q[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }
  // key tiles through registers a tile ahead (rows of D values need not
  // be 16-byte aligned), into the transposed tile, keys past P zero; the
  // thread's elements i = tid + 256 s walk (key, d) by steps
  T kr[kStage];
  const int n64 = kKE * D;
  auto fetch = [&](int t) {
    const T* src = k + static_cast<size_t>(t) * kKE * D;
    const int n = keys(t) * D;
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = tid + s * NTH;
      kr[s] = i < n ? src[i] : T(0.f);
    }
  };
  const int step_key = NTH / D, step_d = NTH % D;
  auto put = [&]() {
    int key = tid / D, d = tid % D;
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      if (tid + s * NTH < n64) ks[d * kLdk + key] = to_f32(kr[s]);
      key += step_key;
      d += step_d;
      if (d >= D) {
        d -= D;
        ++key;
      }
    }
  };
  // one walk over the key tiles: f(t, e) on each tile's energies
  auto walk = [&](auto f) {
    fetch(0);
    for (int t = 0; t < nkt; ++t) {
      __syncthreads();                    // the key tile (and exps) are read
      put();
      if (t + 1 < nkt) fetch(t + 1);
      __syncthreads();                    // the key tile is in
      float e[RM][4];
      tile_energies<RM>(e, qs, ldq, ks, D);
      f(t, e);
    }
  };

  // walk 1: each row's max (exact in any order); in f32 also its sum of
  // exp(e - max) at once, each thread's running sum rescaled as its max
  // rises, then the 16 threads' sums rescaled to the row's max. The f32
  // attention is not rounded, so neither the order of the sum nor the
  // last bits of exp matter there: f32 takes the fast exp (ex2.approx,
  // within a few 1e-7 relative at these energies) and multiplies by 1 /
  // sum; bf16 takes expf and divides, as the plain version does
  float mx[RM], ls[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    mx[i] = -INFINITY;
    ls[i] = 0.f;
  }
  walk([&](int t, float (&e)[RM][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t * kKE + 4 * tx + j >= P) continue;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float x = e[i][j];
        if constexpr (sizeof(T) == 2) {
          mx[i] = fmaxf(mx[i], x);
        } else if (x > mx[i]) {
          ls[i] = ls[i] * __expf(mx[i] - x) + 1.f;
          mx[i] = x;
        } else {
          ls[i] += __expf(x - mx[i]);
        }
      }
    }
  });
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float m = mx[i];
    for (int o = 8; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if constexpr (sizeof(T) == 4) {
      float l = ls[i] * __expf(mx[i] - m);
      for (int o = 8; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (tx == 0) rowl[RM * ty + i] = 1.f / l;   // f32 keeps 1 / sum
    }
    if (tx == 0) rowm[RM * ty + i] = m;
  }

  if constexpr (sizeof(T) == 2) {
    // walk 2 (bf16): each row's sum of exp(e - max), lane l of the row's
    // warp over keys l, l + 32, ... in order, then over the warp
    float sum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sum[r] = 0.f;
    walk([&](int t, float (&e)[RM][4]) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = RM * ty + i;
        const float m = rowm[row];
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = t * kKE + 4 * tx + j < P ? expf(e[i][j] - m) : 0.f;
        }
        *reinterpret_cast<float4*>(ps + row * kLdk + 4 * tx) =
            make_float4(p[0], p[1], p[2], p[3]);
      }
      __syncthreads();                    // the tile's exps are in
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* prow = ps + (kRows * warp + r) * kLdk;
        sum[r] += prow[lane];
        sum[r] += prow[lane + 32];
      }
    });
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      sum[r] = warp_sum(sum[r]);
      if (lane == 0) rowl[kRows * warp + r] = sum[r];
    }
  }
  __syncthreads();                        // the statistics are in, the exps read

  // walk 3: att = exp(e - max) / sum rounded to T, applied to the value
  // sub-tiles u (vk keys each, per of them an energy tile), v(u + 1)
  // loading while v(u) is applied
  auto issue_v = [&](int u) {
    T* dst = vs + (u & 1) * vstage;
    const int k0 = u * vk, nk = min(vk, P - k0);
    mma3::load_rows16(dst, ldv, v + static_cast<size_t>(k0) * C, nk, C, C, 0,
                      NTH);
    mma3::cp_commit();
    if (sizeof(T) == 2 && nk < vk) {
      // the bf16 product runs over all vk keys: past nk the values are
      // zero (so is their attention)
      uint4* z = reinterpret_cast<uint4*>(dst + nk * ldv);
      const int n = (vk - nk) * ldv * static_cast<int>(sizeof(T)) / 16;
      for (int i = tid; i < n; i += NTH) z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  const int wm = warp / WN, wn = warp % WN, m0 = 32 * wm;
  const int ntt = C / 8, npw = (ntt + WN - 1) / WN;
  const int n0t = wn * npw, nt = min(npw, ntt - n0t);
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  issue_v(0);
  fetch(0);
  for (int t = 0; t < nkt; ++t) {
    __syncthreads();                      // the key and attention tiles are read
    put();
    if (t + 1 < nkt) fetch(t + 1);
    __syncthreads();                      // the key tile is in
    {
      float e[RM][4];
      tile_energies<RM>(e, qs, ldq, ks, D);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = RM * ty + i;
        const float m = rowm[row], l = rowl[row];
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = t * kKE + 4 * tx + j < P;
          if constexpr (sizeof(T) == 2) {
            a[j] = in ? expf(e[i][j] - m) / l : 0.f;
          } else {
            a[j] = in ? __expf(e[i][j] - m) * l : 0.f;
          }
        }
        T* dst = att + row * lda + 4 * tx;
        if constexpr (sizeof(T) == 2) {
          __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
          uint2 w;
          w.x = *reinterpret_cast<uint32_t*>(&lo);
          w.y = *reinterpret_cast<uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(dst) = w;
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
        }
      }
    }
    for (int s = 0; s < per; ++s) {
      const int u = t * per + s;
      if (u >= nsub) break;
      const int nk = min(vk, P - u * vk);
      mma3::cp_wait<0>();
      __syncthreads();                    // v(u) and the attention are in
      if (u + 1 < nsub) issue_v(u + 1);
      if (nt <= 0) continue;
      const T* vt = vs + (u & 1) * vstage + 8 * n0t;
      if constexpr (sizeof(T) == 2) {
        mma_rows2_bf16<NT>(acc, att + m0 * lda + s * vk, lda, vt, ldv, vk,
                           nt, lane);
      } else {
        const View a = View{att + s * vk, lda, 1, QT};
        mma3::warp_mma3<2, NT>(acc, {a, a}, {m0, m0 + 16}, 2,
                               View{vt, 1, ldv, C - 8 * n0t}, 0, nk, nt);
      }
    }
  }

  // y[p, c] = g acc + x[p, c]
  const size_t o = static_cast<size_t>(q0) * C;
  const int g4 = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      const int col = 8 * (n0t + j) + t2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + 16 * mi + g4 + 8 * h;
        if (p >= nq) continue;
        const size_t at = o + static_cast<size_t>(p) * C + col;
        const float y0 = acc[mi][j][2 * h], y1 = acc[mi][j][2 * h + 1];
        if constexpr (sizeof(T) == 2) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(x + at);
          *reinterpret_cast<__nv_bfloat162*>(out + at) =
              __floats2bfloat162_rn(g * y0 + __low2float(r),
                                    g * y1 + __high2float(r));
        } else {
          const float2 r = *reinterpret_cast<const float2*>(x + at);
          *reinterpret_cast<float2*>(out + at) =
              make_float2(g * y0 + r.x, g * y1 + r.y);
        }
      }
    }
}

// ------------------------------------------------------- kernels

// Blocks [0, C / 32) of a batch row do CAM, the rest PAM in column ranges
// of pam_cols.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_attention_kernel(const T* __restrict__ xp, const T* __restrict__ q,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ gp, const T* __restrict__ xc,
                      const T* __restrict__ gc, T* __restrict__ outp,
                      T* __restrict__ outc, int P, int C, int D,
                      int pam_cols) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int groups = C / kGroup;
  const size_t ov = static_cast<size_t>(blockIdx.y) * P * C;
  const size_t oq = static_cast<size_t>(blockIdx.y) * P * D;
  const int item = blockIdx.x;
  if (item < groups) {
    cam_block(xc + ov, to_f32(gc[0]), outc + ov, P, C, item * kGroup, sm);
  } else {
    pam_block(xp + ov, q + oq, k + oq, v + ov, to_f32(gp[0]), outp + ov, P,
              C, D, (item - groups) * pam_cols, pam_cols, sm);
  }
}

// The wide kernel's CAM blocks: block (j, b) takes columns 32 j ..
// 32 j + 31 of batch row b's CAM, the positions in tiles of tp rows.
#define WIDE_PARAMS(T)                                                    \
  const T *__restrict__ xc, const T *__restrict__ gc,                     \
      T *__restrict__ outc, int P, int C, int tp

template <typename T, int MC>
__device__ __forceinline__ void cam_row(WIDE_PARAMS(T)) {
  extern __shared__ __align__(16) unsigned char sm[];
  const size_t ov = static_cast<size_t>(blockIdx.y) * P * C;
  cam_wide<T, MC>(xc + ov, to_f32(gc[0]), outc + ov, P, C,
                  blockIdx.x * kGroup, tp, sm);
}

// Two blocks an SM (128 registers): with up to 207 registers one block
// held an SM and the bf16 kernel at C = 512 ran 30-55% slower than its
// predecessor (H100 80GB HBM3, 700 W).
template <typename T, int MC>
__global__ void __launch_bounds__(kThreads, 2)
dual_attention_wide_kernel(WIDE_PARAMS(T)) {
  cam_row<T, MC>(xc, gc, outc, P, C, tp);
}

// The f32 kernel past C = 128: its CAM tile and gram rows (up to 198 KB)
// hold an SM alone, so its registers are not capped.
__global__ void __launch_bounds__(kThreads)
dual_attention_wide_f32(WIDE_PARAMS(float)) {
  cam_row<float, kMaxC>(xc, gc, outc, P, C, tp);
}

// The wide kernel's PAM blocks, launched beside its CAM blocks
// (fork.cuh): block (j, b) takes query tile j of batch row b over all C
// columns. NT: the most n-tiles of a warp; 256 threads (two blocks an SM)
// up to C = 256, 512 past it (one block an SM, 64 accumulators a thread).
template <typename T, int NT, int NTH>
__global__ void __launch_bounds__(NTH, NTH == kThreads ? 2 : 1)
dual_attention_pam_tiles(const T* __restrict__ xp, const T* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ gp, T* __restrict__ outp,
                         int P, int C, int D) {
  extern __shared__ __align__(16) unsigned char sm[];
  const size_t ov = static_cast<size_t>(blockIdx.y) * P * C;
  const size_t oq = static_cast<size_t>(blockIdx.y) * P * D;
  pam_tiles<T, kTileQ, NT, NTH>(xp + ov, q + oq, k + oq, v + ov,
                                to_f32(gp[0]), outp + ov, P, C, D,
                                kTileQ * blockIdx.x, sm);
}

bool takes(int P, int C, int D) {
  return P >= 1 && C >= kGroup && C <= kMaxC && C % kGroup == 0 && D >= 1 &&
         D <= kMaxD;
}

bool narrow(int P, int C) { return P <= kNarrowP && C <= kNarrowC; }

// When the narrow kernel's CAM blocks alone would not fill the SMs twice
// over, PAM is split into 32-column blocks as well, which recompute the
// attention but shorten the row's longest block.
bool few_blocks(int B, int C) {
  return static_cast<long long>(B) * (C / kGroup) < 2LL * fork2::sm_count();
}

// What a launch of B batch rows uses: the narrow kernel's PAM column
// range, or the wide kernel's CAM tile rows, and the dynamic shared memory
// of one (CAM) block.
struct Plan {
  int tp, pam_cols;
  size_t smem;
};

template <typename T>
Plan plan(int B, int P, int C, int D) {
  Plan pl;
  if (narrow(P, C)) {
    pl.tp = P;
    pl.pam_cols = few_blocks(B, C) ? kGroup : C;
    pl.smem = smem_bytes<T>(P, C, D);
  } else {
    pl.tp = cam_bufs(P) > 1 ? tile_rows<T>(C) : P;
    pl.pam_cols = C;
    pl.smem = wide_cam_bytes<T>(P, pl.tp, C);
  }
  return pl;
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The wide kernel's CAM launch on stream s: a block per 32 columns and
// batch row, its registers sized by MC (the most columns).
template <typename T, int MC>
int launch_cam(const Plan& pl, const void* xc, const void* gc, void* outc,
               int B, int P, int C, cudaStream_t s) {
  void (*kernel)(WIDE_PARAMS(T));
  if constexpr (sizeof(T) == 4 && MC == kMaxC) {
    kernel = dual_attention_wide_f32;
  } else {
    kernel = dual_attention_wide_kernel<T, MC>;
  }
  const cudaError_t err = opt_in(kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(C / kGroup, B), kThreads, pl.smem, s>>>(
      static_cast<const T*>(xc), static_cast<const T*>(gc),
      static_cast<T*>(outc), P, C, pl.tp);
  return static_cast<int>(cudaGetLastError());
}

// The wide kernel's PAM launch on stream s: a block per query tile and
// batch row.
template <typename T>
int launch_tiles(const void* xp, const void* q, const void* k, const void* v,
                 const void* gp, void* outp, int B, int P, int C, int D,
                 cudaStream_t s) {
  void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*, int,
                 int, int);
  int threads = kThreads;
  if (C <= kNarrowC) {
    kernel = dual_attention_pam_tiles<T, 4, kThreads>;
  } else if (C <= 256) {
    kernel = dual_attention_pam_tiles<T, 8, kThreads>;
  } else {
    kernel = dual_attention_pam_tiles<T, 8, 2 * kThreads>;
    threads = 2 * kThreads;
  }
  const size_t smem = tiles_bytes<T>(C, D);
  const cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kTileQ - 1) / kTileQ, B);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const T*>(xp), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(gp), static_cast<T*>(outp), P, C, D);
  return static_cast<int>(cudaGetLastError());
}

// C <= 128 and P <= 64 (resnet18/34 at 144x256, the main path) run the
// narrow kernel; a wider C or P the wide one: its PAM launch forked
// beside its CAM launch (sides 1: the CAM launch alone, 2: the PAM launch
// alone, 3: both).
template <typename T>
int launch(const void* xp, const void* q, const void* k, const void* v,
           const void* gp, const void* xc, const void* gc, void* outp,
           void* outc, int B, int P, int C, int D, int sides, void* stream) {
  if (!takes(P, C, D) || sides < 1 || sides > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan<T>(B, P, C, D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (narrow(P, C)) {
    if (sides != 3) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = opt_in(dual_attention_kernel<T>, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(C / kGroup + C / pl.pam_cols, B);
    dual_attention_kernel<T><<<grid, kThreads, pl.smem, st>>>(
        static_cast<const T*>(xp), static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(gp), static_cast<const T*>(xc),
        static_cast<const T*>(gc), static_cast<T*>(outp),
        static_cast<T*>(outc), P, C, D, pl.pam_cols);
    return static_cast<int>(cudaGetLastError());
  }
  // the PAM tiles beside the CAM blocks, joined back on every path once
  // forked
  fork2::Side* sd = nullptr;
  cudaStream_t pst = st;
  int err = 0;
  if (sides == 3) {
    err = static_cast<int>(fork2::fork(st, &sd));
    if (err) return err;
    pst = sd->stream;
  }
  if (sides & 2) err = launch_tiles<T>(xp, q, k, v, gp, outp, B, P, C, D, pst);
  if (!err && (sides & 1)) {
    err = C <= kNarrowC
              ? launch_cam<T, kNarrowC>(pl, xc, gc, outc, B, P, C, st)
              : launch_cam<T, kMaxC>(pl, xc, gc, outc, B, P, C, st);
  }
  if (sides == 3) {
    const int joined = static_cast<int>(fork2::join(st, sd));
    if (!err) err = joined;
  }
  return err;
}

}  // namespace

extern "C" int dual_attention_f32(const void* xp, const void* q, const void* k,
                                  const void* v, const void* gp,
                                  const void* xc, const void* gc, void* outp,
                                  void* outc, int B, int P, int C, int D,
                                  void* stream) {
  return launch<float>(xp, q, k, v, gp, xc, gc, outp, outc, B, P, C, D, 3,
                       stream);
}

extern "C" int dual_attention_bf16(const void* xp, const void* q,
                                   const void* k, const void* v,
                                   const void* gp, const void* xc,
                                   const void* gc, void* outp, void* outc,
                                   int B, int P, int C, int D, void* stream) {
  return launch<bf16>(xp, q, k, v, gp, xc, gc, outp, outc, B, P, C, D, 3,
                      stream);
}

// One side of the wide kernel alone (sides 1: the CAM blocks, 2: the PAM
// blocks; bf16_in != 0: the bf16 kernel), which chip_smoke.py times to
// see which side sets a shape's pace; the other side's output is left
// unwritten. Refuses (cudaErrorInvalidValue) a shape of the narrow kernel.
extern "C" int dual_attention_side(const void* xp, const void* q,
                                   const void* k, const void* v,
                                   const void* gp, const void* xc,
                                   const void* gc, void* outp, void* outc,
                                   int B, int P, int C, int D, int sides,
                                   int bf16_in, void* stream) {
  return bf16_in ? launch<bf16>(xp, q, k, v, gp, xc, gc, outp, outc, B, P, C,
                                D, sides, stream)
                 : launch<float>(xp, q, k, v, gp, xc, gc, outp, outc, B, P,
                                 C, D, sides, stream);
}

// Bytes of dynamic shared memory one block of a launch of B rows uses
// (bf16_in != 0: the bf16 kernel), which chip_smoke.py reports beside the
// kernel's times; -1 for a shape the kernel does not take.
extern "C" long long dual_attention_smem_bytes(int B, int P, int C, int D,
                                               int bf16_in) {
  if (!takes(P, C, D)) return -1;
  size_t b = bf16_in ? plan<bf16>(B, P, C, D).smem : plan<float>(B, P, C, D).smem;
  if (!narrow(P, C)) {
    const size_t t = bf16_in ? tiles_bytes<bf16>(C, D) : tiles_bytes<float>(C, D);
    if (t > b) b = t;
  }
  return static_cast<long long>(b);
}
