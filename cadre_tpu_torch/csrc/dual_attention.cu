// Fused position (PAM) and channel (CAM) attention of the DANet head,
// several blocks per batch row, bf16 products on the tensor cores.
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
// JAX package builds: P <= 256 positions, C a multiple of 32 up to 512
// (a resnet50-152 backbone's 2048 channels / 4), D <= 64 (C / 8).
//
// What bounds it on an H100: bytes. At the main path's shapes (P = 40,
// C = 128, D = 16) a row reads three [P, C] and two [P, D] tensors and
// writes two [P, C] ones, 53.8 KB in bf16, against 3.1 MFLOP, which the
// tensor cores do in a fraction of the time the bytes take: about 0.5 us
// at B = 32 and 4 us at B = 256. At C = 512 a row's CAM is 16x the
// operations (C^2 P) for 4x the bytes, still below the bf16 ridge.
//
// What the first design lost: one block of 512 threads per batch row, so
// at B = 32 only 32 of the 132 SMs worked; the [C, C] gram and both apply
// loops ran as scalar f32 FMAs with two shared-memory operands each, bound
// by shared-memory bandwidth with the tensor cores idle; and 116 KB of
// shared memory per block let only one block onto an SM.
//
// Design: a batch row is split over independent blocks of 256 threads,
// which need no communication:
// - CAM block g (C / 32 of them) computes rows i0 = 32 g .. i0 + 31 of the
//   gram from all of x (10 KB in bf16), their row softmax, and from them
//   columns i0 .. i0 + 31 of the CAM output.
// - A PAM block computes the [P, P] attention and a range of columns of
//   att v: all C of them at large B, where the total work decides; 32 when
//   the CAM blocks alone would leave the SMs short of two blocks each
//   (B * C / 32 < 2 * SMs), where the row's longest block decides.
// At B = 32, C = 128 that is 4 + 4 blocks per row, 256 for 132 SMs; at
// B = 256, 4 + 1 per row, 1,280.
// Two kernels take that split. The narrow one (C <= 128, P <= 64: the
// main path's resnet18/34 heads at 144x256) holds a whole row's x, the
// [P, P] scores and the gram rows at their largest in registers and
// shared memory. The wide one takes the rest of the JAX package's heads,
// up to C = 512 (resnet50-152), P = 256 and D = 64:
// - its CAM blocks stream the positions through shared memory in tiles of
//   tp rows (64 in bf16; in f32 64 up to C = 128, fewer above, so that a
//   tile and the block's attention rows stay near 100 KB): the gram pass
//   walks the tiles forward, the apply pass backward, so the last tile is
//   read once;
// - its PAM blocks take a tile of up to 64 query rows each against all P
//   keys (a [256, 256] f32 score matrix is 256 KB, beyond a block), and
//   fewer than C value columns where they would not fit beside the scores
//   (P > 64, C = 512);
// - the gram rows (CAM) and the scores (PAM) sit in registers sized by the
//   template (C up to 128 or 512, P up to 64 or 256), picked at launch.
// The narrow kernel stays as it was measured: the wide code at the narrow
// shapes ran 4% (f32) to 12% (bf16) slower (H100 80GB HBM3, 700 W).
// bf16: the two products that apply an attention matrix (att v and
// x att^T, 56% of the multiply-adds) are warp-level mma.sync.m16n8k16
// (bf16 in, f32 accumulate), exactly the TPU kernel's contract. Their K
// dimension is padded with zeros in shared memory (P = 40 -> 48), which
// leaves every sum unchanged; M is padded to 16 and the padded rows are
// never stored; padded keys get probability 0, and the attention goes
// into the product as bf16, the rounding the contract asks for. The two
// products that make the energies (q k^T and x^T x) stay on the CUDA
// cores as chains of f32 FMAs in position order, the order of the plain
// version's f32 products: the attention is rounded to bf16, and an energy
// that differs in its last f32 bits (a tensor-core sum rounds in another
// order and way) flips that rounding at some weights, which moves an
// output by up to a bf16 step of its largest term. With all four products
// on the tensor cores the kernel was 8.9 bf16 ulps from the plain version
// at B = 256 (H100 80GB HBM3, 700 W; chip_smoke.py's bound is 4); with the
// same sums the rounding agrees (the wide kernel's chains run on across
// position tiles in order). v enters as stored, row-major, through
// ldmatrix.trans. mma.sync
// rather than wgmma and TMA: the products are 48 x 32 (CAM) and 48 x 128
// (PAM) with K of 48-512 over operands of a few KB, below wgmma's 64-row
// warpgroup tile; the block is bound by its latency, not by the
// tensor-core rate, and row strides of K + 8 bf16 keep the fragment loads
// free of bank conflicts.
// A warp holds whole rows of an energy in its registers, so each row's
// softmax runs there with warp shuffles and only the rounded attention
// goes to shared memory.
// f32: the same split, every product on the CUDA cores (TF32 would break
// the f32 tolerances), each thread accumulating a register tile.
// Shared memory per block at the main path's shapes: 21 KB in bf16, 36 KB
// in f32 (the first design: 116 KB), so several blocks share an SM; in the
// wide kernel at most about 100 KB in bf16 and 180 KB in f32 (P = 256,
// D = 64), opted in per launch above 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;       // channels (CAM) or value columns (PAM)
constexpr int kNarrowC = 128;    // what the narrow kernel takes
constexpr int kNarrowP = 64;
constexpr int kQT = 64;          // query rows of one wide PAM block
constexpr int kMaxC = 512;       // limits the wrapper enforces
constexpr int kMaxP = 256;
constexpr int kMaxD = 64;
constexpr size_t kPamBudget = 100 * 1024;   // wide PAM's shared memory, at
                                            // most, where C allows

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

// The wide kernel's: a CAM tile holds rows = min(P, tp) positions (the
// narrow CAM layouts with P = rows), a PAM block query_rows(P) queries and
// nc value columns.
__host__ __device__ inline int query_rows(int P) { return P < kQT ? P : kQT; }
__host__ __device__ inline size_t wide_pam_bf16_bytes(int P, int D, int nc) {
  const int kp = round16(P);
  return pam_bf16_q(query_rows(P), D) + pam_bf16_k(P, D) + pam_bf16_v(P, nc) +
         align16(static_cast<size_t>(round16(query_rows(P))) * (kp + 8) * 2);
}
__host__ __device__ inline size_t wide_pam_f32_bytes(int P, int D, int nc) {
  const int nq = query_rows(P);
  return f32_region(nq, D) + f32_region(P, D + 1) + f32_region(P, nc) +
         f32_region(nq, P + 1);
}

// Positions a wide CAM tile holds: 64 in bf16 (x at C = 512 is 66 KB a
// tile); in f32 64 up to C = 128, then a multiple of 16 near 8,192 / C.
template <typename T> int tile_rows(int C);
template <> int tile_rows<bf16>(int) { return 64; }
template <> int tile_rows<float>(int C) {
  if (C <= 128) return 64;
  const int t = 8192 / C / 16 * 16;
  return t < 16 ? 16 : t;
}
template <typename T> size_t wide_cam_bytes(int rows, int C);
template <> size_t wide_cam_bytes<float>(int rows, int C) {
  return cam_f32_bytes(rows, C);
}
template <> size_t wide_cam_bytes<bf16>(int rows, int C) {
  return cam_bf16_bytes(rows, C);
}
template <typename T> size_t wide_pam_bytes(int P, int D, int nc);
template <> size_t wide_pam_bytes<float>(int P, int D, int nc) {
  return wide_pam_f32_bytes(P, D, nc);
}
template <> size_t wide_pam_bytes<bf16>(int P, int D, int nc) {
  return wide_pam_bf16_bytes(P, D, nc);
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

// ------------------------------------------------------- wide bf16 blocks

// Rows [0, np) of a [np, C] bf16 tile of x into xr (row stride ldx), rows
// np .. round16(np) zeroed (padded M rows of the apply).
__device__ __forceinline__ void load_tile(bf16* xr, int ldx,
                                          const bf16* __restrict__ x, int np,
                                          int C) {
  zero_smem(xr + np * ldx, static_cast<size_t>(round16(np) - np) * ldx * 2);
  for (int i = threadIdx.x; i < (C / 8) * np; i += kThreads) {
    const int p = i / (C / 8), c8 = i % (C / 8);
    *reinterpret_cast<uint4*>(xr + p * ldx + c8 * 8) =
        *reinterpret_cast<const uint4*>(x + p * C + c8 * 8);
  }
}

// CAM columns i0 .. i0 + 31 of one batch row; x, out: [P, C]; positions in
// tiles of tp rows.
template <int MC>
__device__ void cam_wide(const bf16* __restrict__ x, float g,
                          bf16* __restrict__ out, int P, int C, int i0,
                          int tp, unsigned char* sm) {
  const int ldx = C + 8;                  // x and att rows
  bf16* xr = reinterpret_cast<bf16*>(sm);
  bf16* att = reinterpret_cast<bf16*>(sm + cam_bf16_xr(min(P, tp), C));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (P + tp - 1) / tp;

  // gram rows i0 + 8 w .. i0 + 8 w + 7 (warp w), E[i, j] = sum_p x[p, i]
  // x[p, j] at j = l + 32 u (lane l), as chains of f32 FMAs over p in order
  // (see gemm_f32), tile after tile, then their softmax in the registers
  // of the warp
  constexpr int kRows = kGroup / kWarps;
  float e[kRows][MC / 32];
  zero_acc(e);
  const bf16* rows = xr + i0 + kRows * warp;
  for (int t = 0; t < ntiles; ++t) {
    const int p0 = t * tp, np = min(tp, P - p0);
    if (t > 0) __syncthreads();           // the previous tile is read
    load_tile(xr, ldx, x + static_cast<size_t>(p0) * C, np, C);
    __syncthreads();
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
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    softmax_row(e[r], C, C, true, att + (kRows * warp + r) * ldx, lane);
  }
  __syncthreads();

  // y[p, i0 + i] = g * sum_j x[p, j] att[i, j] + x[p, i0 + i], the last
  // tile first (it is in shared memory), the others loaded again
  for (int t = ntiles - 1; t >= 0; --t) {
    const int p0 = t * tp, np = min(tp, P - p0);
    if (t < ntiles - 1) {
      __syncthreads();                    // the tile after it is applied
      load_tile(xr, ldx, x + static_cast<size_t>(p0) * C, np, C);
      __syncthreads();
    }
    apply_bf16<false>(xr, ldx, att, ldx, C, round16(np), kGroup, np, g, xr,
                      ldx, out + static_cast<size_t>(p0) * C, C, i0);
  }
}

// PAM of query rows q0 .. q0 + 63 and columns c0 .. c0 + nc - 1 of one
// batch row; x, v, out: [P, C]; q, k: [P, D].
template <int MP>
__device__ void pam_wide(const bf16* __restrict__ x,
                          const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, float g,
                          bf16* __restrict__ out, int P, int C, int D, int q0,
                          int c0, int nc, unsigned char* sm) {
  const int kp = round16(P);
  const int nq = min(kQT, P - q0);        // query rows of this block
  const int ldk = D + 1;                  // k rows
  const int ldv = nc + 8;                 // v rows
  const int lda = kp + 8;                 // att rows
  bf16* qs = reinterpret_cast<bf16*>(sm);
  unsigned char* next = sm + pam_bf16_q(query_rows(P), D);
  bf16* ks = reinterpret_cast<bf16*>(next);
  next += pam_bf16_k(P, D);
  bf16* vs = reinterpret_cast<bf16*>(next);
  bf16* att = reinterpret_cast<bf16*>(next + pam_bf16_v(P, nc));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // padded keys of v and padded query rows of att are zero
  zero_smem(vs + P * ldv, static_cast<size_t>(kp - P) * ldv * 2);
  zero_smem(att + nq * lda, static_cast<size_t>(round16(nq) - nq) * lda * 2);
  for (int i = tid; i < nq * D; i += kThreads) qs[i] = q[q0 * D + i];
  for (int i = tid; i < P * D; i += kThreads) {
    ks[(i / D) * ldk + i % D] = k[i];
  }
  for (int i = tid; i < (nc / 8) * P; i += kThreads) {
    const int key = i / (nc / 8), c8 = i % (nc / 8);
    *reinterpret_cast<uint4*>(vs + key * ldv + c8 * 8) =
        *reinterpret_cast<const uint4*>(v + key * C + c0 + c8 * 8);
  }
  __syncthreads();

  // energy [nq, P] = q k^T and its softmax in registers; padded keys get
  // probability 0
  float s[kQT / kWarps][MP / 32];
  gemm_f32(
      nq, P, D, [&](int p, int d) { return __bfloat162float(qs[p * D + d]); },
      [&](int d, int key) { return __bfloat162float(ks[key * ldk + d]); }, s);
#pragma unroll
  for (int i = 0; i < kQT / kWarps; ++i) {
    const int row = warp + kWarps * i;
    if (row < nq) softmax_row(s[i], P, kp, false, att + row * lda, lane);
  }
  __syncthreads();

  // y[p, c0 + c] = g * sum_key att[p, key] v[key, c0 + c] + x[p, c0 + c]
  const size_t o = static_cast<size_t>(q0) * C;
  apply_bf16<true>(att, lda, vs, ldv, kp, round16(nq), nc, nq, g, x + o, C,
                   out + o, C, c0);
}

// ------------------------------------------------------- wide f32 blocks

template <int MC>
__device__ void cam_wide(const float* __restrict__ x, float g,
                          float* __restrict__ out, int P, int C, int i0,
                          int tp, unsigned char* sm) {
  const int lda = C + 1;
  float* xs = reinterpret_cast<float*>(sm);             // [tile rows, C]
  float* att = reinterpret_cast<float*>(sm + f32_region(min(P, tp), C));
                                                        // [32, C + 1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (P + tp - 1) / tp;
  auto load = [&](int p0, int np) {
    const float4* src = reinterpret_cast<const float4*>(
        x + static_cast<size_t>(p0) * C);
    for (int i = tid; i < np * C / 4; i += kThreads) {
      reinterpret_cast<float4*>(xs)[i] = src[i];
    }
  };
  float e[kGroup / kWarps][MC / 32];
  zero_acc(e);
  for (int t = 0; t < ntiles; ++t) {
    const int p0 = t * tp, np = min(tp, P - p0);
    if (t > 0) __syncthreads();
    load(p0, np);
    __syncthreads();
    gemm_f32_acc(kGroup, C, np, [&](int m, int p) { return xs[p * C + i0 + m]; },
                 [&](int p, int n) { return xs[p * C + n]; }, e);
  }
#pragma unroll
  for (int i = 0; i < kGroup / kWarps; ++i) {
    softmax_row(e[i], C, C, true, att + (warp + kWarps * i) * lda, lane);
  }
  __syncthreads();
  for (int t = ntiles - 1; t >= 0; --t) {
    const int p0 = t * tp, np = min(tp, P - p0);
    if (t < ntiles - 1) {
      __syncthreads();
      load(p0, np);
      __syncthreads();
    }
    float y[kQT / kWarps][1];
    gemm_f32(np, kGroup, C, [&](int p, int j) { return xs[p * C + j]; },
             [&](int j, int i) { return att[i * lda + j]; }, y);
#pragma unroll
    for (int i = 0; i < kQT / kWarps; ++i) {
      const int p = warp + kWarps * i;
      if (p < np) {
        out[static_cast<size_t>(p0 + p) * C + i0 + lane] =
            g * y[i][0] + xs[p * C + i0 + lane];
      }
    }
  }
}

template <int MP>
__device__ void pam_wide(const float* __restrict__ x,
                          const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float g,
                          float* __restrict__ out, int P, int C, int D,
                          int q0, int c0, int nc, unsigned char* sm) {
  const int nq = min(kQT, P - q0);
  const int ldk = D + 1;
  const int lda = P + 1;
  float* qs = reinterpret_cast<float*>(sm);                  // [nq, D]
  unsigned char* next = sm + f32_region(query_rows(P), D);
  float* ks = reinterpret_cast<float*>(next);                // [P, D + 1]
  next += f32_region(P, ldk);
  float* vs = reinterpret_cast<float*>(next);                // [P, nc]
  float* att = reinterpret_cast<float*>(next + f32_region(P, nc));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < nq * D; i += kThreads) qs[i] = q[q0 * D + i];
  for (int i = tid; i < P * D; i += kThreads) {
    ks[(i / D) * ldk + i % D] = k[i];
  }
  for (int i = tid; i < P * nc / 4; i += kThreads) {
    const int key = i / (nc / 4), c4 = i % (nc / 4);
    reinterpret_cast<float4*>(vs)[i] =
        *reinterpret_cast<const float4*>(v + key * C + c0 + 4 * c4);
  }
  __syncthreads();
  float s[kQT / kWarps][MP / 32];
  gemm_f32(nq, P, D, [&](int p, int d) { return qs[p * D + d]; },
           [&](int d, int key) { return ks[key * ldk + d]; }, s);
#pragma unroll
  for (int i = 0; i < kQT / kWarps; ++i) {
    const int row = warp + kWarps * i;
    if (row < nq) softmax_row(s[i], P, P, false, att + row * lda, lane);
  }
  __syncthreads();
  for (int cg = 0; cg < nc; cg += kGroup) {
    float y[kQT / kWarps][1];
    gemm_f32(nq, kGroup, P, [&](int p, int key) { return att[p * lda + key]; },
             [&](int key, int c) { return vs[key * nc + cg + c]; }, y);
#pragma unroll
    for (int i = 0; i < kQT / kWarps; ++i) {
      const int p = warp + kWarps * i;
      if (p < nq) {
        const size_t o = static_cast<size_t>(q0 + p) * C + c0 + cg + lane;
        out[o] = g * y[i][0] + x[o];
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

// Blocks [0, C / 32) of a batch row do CAM, the rest PAM, one per query
// tile (64 rows) and column range (pam_cols) of the row.
template <typename T, int MC, int MP>
__device__ __forceinline__ void wide_row(
    const T* __restrict__ xp, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ gp, const T* __restrict__ xc,
    const T* __restrict__ gc, T* __restrict__ outp, T* __restrict__ outc,
    int P, int C, int D, int pam_cols, int tp) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int groups = C / kGroup;
  const size_t ov = static_cast<size_t>(blockIdx.y) * P * C;
  const size_t oq = static_cast<size_t>(blockIdx.y) * P * D;
  const int item = blockIdx.x;
  if (item < groups) {
    cam_wide<MC>(xc + ov, to_f32(gc[0]), outc + ov, P, C, item * kGroup, tp,
                 sm);
  } else {
    const int j = item - groups, ranges = C / pam_cols;
    pam_wide<MP>(xp + ov, q + oq, k + oq, v + ov, to_f32(gp[0]), outp + ov,
                 P, C, D, (j / ranges) * kQT, (j % ranges) * pam_cols,
                 pam_cols, sm);
  }
}

#define WIDE_PARAMS(T)                                                    \
  const T *__restrict__ xp, const T *__restrict__ q,                      \
      const T *__restrict__ k, const T *__restrict__ v,                   \
      const T *__restrict__ gp, const T *__restrict__ xc,                 \
      const T *__restrict__ gc, T *__restrict__ outp,                     \
      T *__restrict__ outc, int P, int C, int D, int pam_cols, int tp

template <typename T, int MC, int MP>
__global__ void __launch_bounds__(kThreads)
dual_attention_wide_kernel(WIDE_PARAMS(T)) {
  wide_row<T, MC, MP>(xp, q, k, v, gp, xc, gc, outp, outc, P, C, D, pam_cols,
                      tp);
}

// The f32 deep head's (C > 128, P <= 64: resnet50-152 pretraining) at two
// blocks an SM, 128 registers: at one (182 registers) it measured 10-17%
// slower, its few bytes of spills included (H100 80GB HBM3, 700 W). A
// template-dependent __launch_bounds__ moved the register counts of every
// other instantiation, so it is a kernel of its own.
__global__ void __launch_bounds__(kThreads, 2)
dual_attention_deep_f32(WIDE_PARAMS(float)) {
  wide_row<float, kMaxC, 64>(xp, q, k, v, gp, xc, gc, outp, outc, P, C, D,
                             pam_cols, tp);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      count = 1;
    }
  }
  return count;
}

bool takes(int P, int C, int D) {
  return P >= 1 && P <= kMaxP && C >= kGroup && C <= kMaxC &&
         C % kGroup == 0 && D >= 1 && D <= kMaxD;
}

bool narrow(int P, int C) { return P <= kNarrowP && C <= kNarrowC; }

// When the CAM blocks alone would not fill the SMs twice over, PAM is
// split into 32-column blocks as well, which recompute the attention but
// shorten the row's longest block.
bool few_blocks(int B, int C) {
  return static_cast<long long>(B) * (C / kGroup) < 2LL * sm_count();
}

// What a launch of B batch rows uses: the CAM tile rows, PAM's column
// range and the dynamic shared memory of one block (the narrow kernel
// reads only the last two).
struct Plan {
  int tp, pam_cols;
  size_t smem;
};

template <typename T>
Plan plan(int B, int P, int C, int D) {
  Plan pl;
  pl.tp = tile_rows<T>(C);
  int nc = few_blocks(B, C) ? kGroup : C;
  if (narrow(P, C)) {
    pl.pam_cols = nc;
    pl.smem = smem_bytes<T>(P, C, D);
    return pl;
  }
  // the wide kernel narrows PAM's column range while v's columns and the
  // scores would take more shared memory than CAM or kPamBudget
  const size_t cam = wide_cam_bytes<T>(P < pl.tp ? P : pl.tp, C);
  const size_t budget = cam > kPamBudget ? cam : kPamBudget;
  while (nc > kGroup && wide_pam_bytes<T>(P, D, nc) > budget) {
    do {
      nc -= kGroup;
    } while (C % nc);
  }
  pl.pam_cols = nc;
  const size_t pam = wide_pam_bytes<T>(P, D, nc);
  pl.smem = cam > pam ? cam : pam;
  return pl;
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int MC, int MP>
int launch_wide(const Plan& pl, const void* xp, const void* q, const void* k,
                const void* v, const void* gp, const void* xc, const void* gc,
                void* outp, void* outc, int B, int P, int C, int D,
                void* stream) {
  void (*kernel)(WIDE_PARAMS(T));
  if constexpr (sizeof(T) == 4 && MC == kMaxC && MP == 64) {
    kernel = dual_attention_deep_f32;
  } else {
    kernel = dual_attention_wide_kernel<T, MC, MP>;
  }
  const cudaError_t err = opt_in(kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqt = (P + kQT - 1) / kQT;
  const dim3 grid(C / kGroup + nqt * (C / pl.pam_cols), B);
  kernel<<<grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(gp), static_cast<const T*>(xc),
      static_cast<const T*>(gc), static_cast<T*>(outp),
      static_cast<T*>(outc), P, C, D, pl.pam_cols, pl.tp);
  return static_cast<int>(cudaGetLastError());
}

// C <= 128 and P <= 64 (resnet18/34 at 144x256, the main path) run the
// narrow kernel; a wider C or P the wide one, its registers sized by the
// template picked here.
template <typename T>
int launch(const void* xp, const void* q, const void* k, const void* v,
           const void* gp, const void* xc, const void* gc, void* outp,
           void* outc, int B, int P, int C, int D, void* stream) {
  if (!takes(P, C, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan<T>(B, P, C, D);
  if (narrow(P, C)) {
    const cudaError_t err = opt_in(dual_attention_kernel<T>, pl.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(C / kGroup + C / pl.pam_cols, B);
    dual_attention_kernel<T><<<grid, kThreads, pl.smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xp), static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(gp), static_cast<const T*>(xc),
        static_cast<const T*>(gc), static_cast<T*>(outp),
        static_cast<T*>(outc), P, C, D, pl.pam_cols);
    return static_cast<int>(cudaGetLastError());
  }
  if (C <= kNarrowC) {
    return launch_wide<T, kNarrowC, kMaxP>(pl, xp, q, k, v, gp, xc, gc, outp,
                                           outc, B, P, C, D, stream);
  }
  return P <= kNarrowP
             ? launch_wide<T, kMaxC, kNarrowP>(pl, xp, q, k, v, gp, xc, gc,
                                               outp, outc, B, P, C, D, stream)
             : launch_wide<T, kMaxC, kMaxP>(pl, xp, q, k, v, gp, xc, gc,
                                            outp, outc, B, P, C, D, stream);
}

}  // namespace

extern "C" int dual_attention_f32(const void* xp, const void* q, const void* k,
                                  const void* v, const void* gp,
                                  const void* xc, const void* gc, void* outp,
                                  void* outc, int B, int P, int C, int D,
                                  void* stream) {
  return launch<float>(xp, q, k, v, gp, xc, gc, outp, outc, B, P, C, D,
                       stream);
}

extern "C" int dual_attention_bf16(const void* xp, const void* q,
                                   const void* k, const void* v,
                                   const void* gp, const void* xc,
                                   const void* gc, void* outp, void* outc,
                                   int B, int P, int C, int D, void* stream) {
  return launch<bf16>(xp, q, k, v, gp, xc, gc, outp, outc, B, P, C, D,
                      stream);
}

// Bytes of dynamic shared memory one block of a launch of B rows uses
// (bf16_in != 0: the bf16 kernel), which chip_smoke.py reports beside the
// kernel's times; -1 for a shape the kernel does not take.
extern "C" long long dual_attention_smem_bytes(int B, int P, int C, int D,
                                               int bf16_in) {
  if (!takes(P, C, D)) return -1;
  return static_cast<long long>(bf16_in ? plan<bf16>(B, P, C, D).smem
                                        : plan<float>(B, P, C, D).smem);
}
