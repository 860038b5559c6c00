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
// (C / 8). No block's shared memory grows with P but the bf16 PAM's,
// which keeps its energies up to a limit (below) and walks them past it.
//
// What bounds it on an H100: at the main path's shapes (P = 40, C = 128,
// D = 16, bf16) bytes: a row reads three [P, C] and two [P, D] tensors and
// writes two [P, C] ones, 53.8 KB in bf16, against 3.1 MFLOP: about 0.5 us
// at B = 32 and 4 us at B = 256. A row's CAM is C^2 P multiply-adds for
// 3 C P values, so at C = 512 in f32 the operations bound it (0.024 ms at
// B = 48, P = 40 as f32 FMA at 67 TFLOP/s), and its PAM is P^2 C for the
// same bytes, so a large camera (P = 475 at 800x600) is bound by
// operations too. In bf16 the exact-rounding contract below keeps the
// energies and the gram on the CUDA cores; formed once each (one chain a
// symmetric gram pair), they are C (C + 1) / 2 P + P^2 D FMA a row, so the
// bf16 kernel's floor is those chains at 33.5 TFMA/s (0.110 ms at B = 48,
// P = 475, C = 512), beside the applies on the tensor cores.
//
// Design: a batch row is split over independent blocks, which need no
// communication within a launch. Two kernels take that split. The narrow
// one (C <= 128, P <= 64: the main path's resnet18/34 heads at 144x256)
// holds a whole row's x, the [P, P] scores and the gram rows at their
// largest in registers and shared memory, one launch of 256-thread blocks:
// CAM block g (C / 32 of them) computes rows i0 = 32 g .. i0 + 31 of the
// gram, their row softmax, and from them columns i0 .. i0 + 31 of the CAM
// output; a PAM block att v for a range of columns. It stays as it was
// measured: wide code at those shapes ran 4% (f32) to 12% (bf16) slower
// (H100 80GB HBM3, 700 W). The wide one takes the rest, any P, its PAM
// launch forked from the caller's stream onto a second one and joined back
// (fork.cuh), beside its CAM launches, each launch with its own registers
// and shared memory. Issued one after the other on the caller's stream
// instead, the f32 P = 144 row ran 20% slower (same card, chip_smoke.py
// --kernel-times).
// - The PAM blocks (dual_attention_pam_tiles) take a 64-query tile each
//   over all C value columns (256 threads up to C = 256, 512 past it, 64
//   accumulators a thread), so that each energy is not formed again for
//   each column range. Its key tiles (64 keys) sit transposed in shared
//   memory as f32 and each thread forms a 4 x 4 (or 2 x 4) register tile of
//   q k^T whose operands are two vector loads a step. f32 walks the key
//   tiles twice: the first keeps each thread's running max and sum (fast
//   exp; the f32 attention is not rounded, so neither the order of the sum
//   nor exp's last bits matter), the second applies. bf16 forms each energy
//   once (dual_attention_pam_kept, 32-query tiles up to C = 128; two groups
//   of threads forming alternate key tiles, 4 x 4 register tiles) and keeps
//   it in shared memory for the max, the sum of exp(e - max) in the plain
//   version's warp order (lane l of a row's warp adding keys l, l + 32, ...
//   in order) and att = exp(e - max) / sum rounded to bf16, written over
//   the row's front; past the P where a block's energies do not fit the
//   card's shared memory (640 at C = 512, 632 at 256, 1,536 at 128) it
//   walks the key tiles three times instead, forming them again each walk.
//   The value tiles (32 or 64 keys) come two stages deep by cp.async and
//   the applies run on the tensor cores, each warp owning 32 query rows and
//   a column range.
// - f32 CAM blocks stream the positions through shared memory in tiles
//   (all of P in one tile up to 64 positions; past that 64 or 32 rows a
//   tile, two in flight by cp.async), a block per 32 gram rows: the gram
//   pass walks the tiles forward, the apply pass backward.
// - The bf16 CAM is three launches on the caller's stream: the gram, each
//   symmetric pair once (dual_attention_cam_gram: a block per upper-
//   triangle tile, f32 FMA register tiles, mirrored into a [B, C, C] f32
//   scratch the wrapper allocates), the softmax of every gram row (a warp a
//   row, the bf16 attention written over the row), and the apply x att^T
//   (a tiled GEMM on the tensor cores). The gram launch is forked onto a
//   side stream of the greatest priority, so that its blocks take the SMs
//   before the PAM launch's, which stays on the caller's stream; the
//   softmax and apply follow it on a default-priority side stream.
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
// sums) to more than 4 ulps at the 800x600 shapes, and the mirrored gram
// and the kept energies bit-equal to the ordered chains. Formed once, each
// gram element and energy is the same chain as before, so the wide bf16
// kernel's outputs are its predecessor's bit for bit.
// f32: the narrow kernel's products run on the CUDA cores; the wide
// kernel's gram and both applies run on the tensor cores in 3xTF32
// (mma_tf32.cuh: plain TF32 would break the f32 tolerances, 3xTF32 is as
// accurate as f32 FMA at these sums); its energies q k^T are f32 FMA
// chains (D <= 64 deep, a small share of the work beside C-wide applies).
// mma.sync rather than wgmma and TMA: the applies are 16 to 64 rows by 32
// to 128 columns a warp, where the blocks are bound by their latency and,
// in the bf16 CAM's GEMM, by the bytes from L2, not by the tensor-core
// rate; row strides are padded so that the fragment loads are free of bank
// conflicts, or nearly.
// Shared memory per block at the main path's shapes: 21 KB in bf16, 36 KB
// in f32 (the first design: 116 KB), so several blocks share an SM; in the
// wide kernel's f32 CAM blocks at most 198 KB (C = 512), its f32 PAM
// blocks 186 KB and the bf16 walks 111 KB, whatever P; the bf16 kept
// energies up to the card's 227 KB (190,720 B at C = 512, P = 475), the
// gram blocks 24 KB and the CAM GEMM's 80 KB; opted in per launch above
// 48 KB.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py --kernel-times,
// graph ms at B = 48): P = 475 f32 C = 128 0.2247, bf16 0.1114, f32 C =
// 512 1.6237, bf16 0.5504 (bound by operations: the bf16 gram's FMA chains
// at 37% of the FMA rate beside the PAM, the f32 gram and applies in
// 3xTF32); P = 144 f32 0.0524, bf16 0.0259; C = 512, P = 40 f32 0.1626,
// bf16 B = 32 0.0580. More in PERF.md.

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

// The wide f32 kernel's CAM position tile's row stride past C.
template <typename T> struct Wide;
template <> struct Wide<float> {
  static constexpr int kPadX = 4;
};

// Rows of an f32 CAM tile: all of P in one tile up to 64 positions, else
// tile_rows in two buffers (a tile of x is at most 66 KB, so that two of
// them and the gram rows stay near 100 KB, or, at C > 256, within one
// block an SM).
inline int tile_rows(int C) { return C <= 128 ? 64 : 32; }

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

// The gram rows of an f32 CAM block, in 3xTF32 on the tensor cores, a warp
// holding both 16-row m-tiles of C / 64 n-tiles (or fewer) of 8 columns.
// (The bf16 gram is a launch of its own: dual_attention_cam_gram.)
template <typename T, int MC> struct CamGram;

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
// np rows of one tile (f32, 3xTF32)
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

// energies e = q k^T of thread (ty, tx) = (t / 16, t % 16)'s RM x 4 tile
// (see above)
template <int RM>
__device__ __forceinline__ void tile_energies(float (&e)[RM][4],
                                              const float* qs, int ldq,
                                              const float* ks, int D,
                                              int t = threadIdx.x) {
  const float* qp = qs + RM * (t >> 4);
  const float* kp = ks + 4 * (t & 15);
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

// q^T of query rows q0 .. q0 + QT - 1 into qs [D][ldq] (f32), rows past
// nq zero.
template <typename T, int QT, int NTH>
__device__ __forceinline__ void load_qt(float* qs, int ldq,
                                        const T* __restrict__ q, int q0,
                                        int nq, int D) {
  for (int i = threadIdx.x; i < QT * D; i += NTH) {
    const int r = i / D, d = i % D;
    qs[d * ldq + r] =
        r < nq ? to_f32(q[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
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

// y[p, c] = g acc + x[p, c] for a warp's accumulators of a PAM block (rows
// m0 .. m0 + 31 of the query tile at offset o, n-tiles n0t .. n0t + nt -
// 1), rows past nq not stored.
template <typename T, int NT>
__device__ __forceinline__ void store_pam(const float (&acc)[2][NT][4],
                                          float g, const T* __restrict__ x,
                                          T* __restrict__ out, size_t o,
                                          int C, int m0, int n0t, int nt,
                                          int nq) {
  const int lane = threadIdx.x & 31;
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

  load_qt<T, QT, NTH>(qs, ldq, q, q0, nq, D);
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

  store_pam<T, NT>(acc, g, x, out, static_cast<size_t>(q0) * C, C, m0, n0t,
                   nt, nq);
}

// ------------------------------------------------------- kept energies
//
// The bf16 PAM with each energy formed once (pam_kept): a block per query
// tile of QT rows over all C columns, as pam_tiles, but the key tiles are
// walked once, by groups of 4 QT threads taking alternate tiles (a 4 x 4
// register tile a thread: half the shared loads per FMA of a 2 x 4 one;
// C = 512, P = 475: the PAM launch 0.198 against 0.206 ms with one group
// of 2 x 4 tiles, H100 80GB HBM3, 700 W). Their energies (the same ordered
// f32 FMA chains over d) go to a [QT][lde] f32 region and stay there, with
// each thread's running max; then a row's warp turns its row into
// exp(e - max) in place, summing in the plain version's warp order (lane
// l: keys l, l + 32, ... in order, then the butterfly), and into att =
// exp(e - max) / sum rounded to bf16, written over the front of the same
// row (row stride 2 lde in bf16); then the value sub-tiles are applied to
// it. The values read back are
// the values formed, so the rounded attention is pam_tiles' bit for bit.
// The q^T and key tiles share their room with the two value stages, which
// are needed only once the energies are formed. The energies grow with P:
// past the P where a block's regions exceed the card's shared memory
// (kept_bytes against fork2::smem_optin) the three walks of pam_tiles run
// instead.

// The energy region's row stride: room for P energies and for the
// attention of every value sub-tile (at most 64 nkt bf16), 4 mod 8 words,
// so that a fragment's 8 rows of bf16 pairs hit distinct banks.
__host__ __device__ inline int kept_lde(int P) {
  const int nkt = (P + kKE - 1) / kKE;
  const int n = P > 32 * nkt ? P : 32 * nkt;
  return (n + 7) / 8 * 8 + 4;
}
// Regions: the energies [QT][lde], the groups' row maxima [NG][QT], then
// q^T [D][QT + 4] and a key tile [D][kLdk] a group (f32), whose room the
// two value stages [vk][C + 8] take once the energies are formed.
__host__ __device__ inline size_t kept_union(int C, int D, int QT, int NG) {
  const size_t qk = align16(static_cast<size_t>(D) * (QT + 4) * 4) +
                    NG * align16(static_cast<size_t>(D) * kLdk * 4);
  const size_t v = 2 * align16(static_cast<size_t>(pam_vk<bf16>(C)) *
                               (C + 8) * 2);
  return qk > v ? qk : v;
}
__host__ __device__ inline size_t kept_bytes(int P, int C, int D, int QT,
                                             int NG) {
  return align16(static_cast<size_t>(QT) * kept_lde(P) * 4) +
         align16(static_cast<size_t>(NG) * QT * 4) + kept_union(C, D, QT, NG);
}

// bar.sync on barrier 1 + g by the n threads of group g (barrier 0 is
// __syncthreads')
__device__ __forceinline__ void group_sync(int g, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(n) : "memory");
}

template <int QT, int NT, int NTH>
__device__ void pam_kept(const bf16* __restrict__ x, const bf16* __restrict__ q,
                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                         float g, bf16* __restrict__ out, int P, int C, int D,
                         int q0, unsigned char* sm) {
  constexpr int kW = NTH / 32;          // warps
  constexpr int kGT = 4 * QT, NG = NTH / kGT;   // energy groups, threads
  constexpr int kRows = QT / kW;
  constexpr int WM = QT / 32, WN = kW / WM;
  const int nq = min(QT, P - q0), nkt = (P + kKE - 1) / kKE;
  const int vk = pam_vk<bf16>(C), nsub = (P + vk - 1) / vk;
  const int ldq = QT + 4, lde = kept_lde(P), ldv = C + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* es = reinterpret_cast<float*>(sm);
  unsigned char* next = sm + align16(static_cast<size_t>(QT) * lde * 4);
  float* rowm = reinterpret_cast<float*>(next);     // [NG][QT]
  next += align16(static_cast<size_t>(NG) * QT * 4);
  float* qs = reinterpret_cast<float*>(next);       // the energy phase
  float* ks0 = reinterpret_cast<float*>(
      next + align16(static_cast<size_t>(D) * ldq * 4));
  bf16* vs = reinterpret_cast<bf16*>(next);         // the apply phase
  const size_t vstage = align16(static_cast<size_t>(vk) * ldv * 2) / 2;

  // the energies, once, by NG groups of kGT threads: group gr forms the
  // key tiles gr, gr + NG, ... with a key tile and a barrier of its own,
  // so that one group's loads overlap another's FMAs, each thread a 4 x 4
  // register tile (rows 4 gy .., keys 4 gx ..) and its rows' running max
  load_qt<bf16, QT, NTH>(qs, ldq, q, q0, nq, D);
  const int gr = tid / kGT, lt = tid % kGT, gy = lt >> 4, gx = lt & 15;
  float* ks = ks0 + gr * (align16(static_cast<size_t>(D) * kLdk * 4) / 4);
  const int step_key = kGT / D, step_d = kGT % D;
  float mx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[i] = -INFINITY;
  __syncthreads();                        // q^T is in
  for (int t = gr; t < nkt; t += NG) {
    group_sync(gr, kGT);                  // the group's last tile is read
    // tile t transposed into ks (keys past P zero): element i = lt + kGT s
    // of the tile's (key, d), walked by steps
    const bf16* src = k + static_cast<size_t>(t) * kKE * D;
    const int n = min(kKE, P - t * kKE) * D;
    int key = lt / D, d = lt % D;
#pragma unroll 4
    for (int i = lt; i < kKE * D; i += kGT) {
      ks[d * kLdk + key] = i < n ? __bfloat162float(src[i]) : 0.f;
      key += step_key;
      d += step_d;
      if (d >= D) {
        d -= D;
        ++key;
      }
    }
    group_sync(gr, kGT);                  // the tile is in
    float e[4][4];
    tile_energies<4>(e, qs, ldq, ks, D, lt);
    const int key0 = t * kKE + 4 * gx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (key0 + j < P) mx[i] = fmaxf(mx[i], e[i][j]);
      }
      if (key0 < P) {
        *reinterpret_cast<float4*>(es + (4 * gy + i) * lde + key0) =
            make_float4(e[i][0], e[i][1], e[i][2], e[i][3]);
      }
    }
  }
  // each row's max over its 16 threads, a share a group
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m = mx[i];
    for (int o = 8; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (gx == 0) rowm[gr * QT + 4 * gy + i] = m;
  }
  __syncthreads();     // the energies and maxima are in; q^T and keys read

  // v(0) loads while the rows' softmax runs
  auto issue_v = [&](int u) {
    bf16* dst = vs + (u & 1) * vstage;
    const int k0 = u * vk, nk = min(vk, P - k0);
    mma3::load_rows16(dst, ldv, v + static_cast<size_t>(k0) * C, nk, C, C, 0,
                      NTH);
    mma3::cp_commit();
    if (nk < vk) {
      // the product runs over all vk keys: past nk the values are zero
      // (so is their attention)
      uint4* z = reinterpret_cast<uint4*>(dst + nk * ldv);
      const int n = (vk - nk) * ldv * 2 / 16;
      for (int i = tid; i < n; i += NTH) z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  issue_v(0);

  // each row of the warp: exp(e - max) in place and its sum (lane l over
  // keys l, l + 32, ... of every key tile in order, then over the warp);
  // then att = exp / sum rounded to bf16 over the row's front, zero past P
  for (int r = 0; r < kRows; ++r) {
    const int row = kRows * warp + r;
    float* er = es + row * lde;
    float m = rowm[row];
    for (int h = 1; h < NG; ++h) m = fmaxf(m, rowm[h * QT + row]);
    float s = 0.f;
    for (int k0 = 0; k0 < nkt * kKE; k0 += 32) {
      const int key = k0 + lane;
      float ex = 0.f;
      if (key < P) {
        ex = expf(er[key] - m);
        er[key] = ex;
      }
      s += ex;
    }
    s = warp_sum(s);
    bf16* ar = reinterpret_cast<bf16*>(er);
    for (int k0 = 0; k0 < nsub * vk; k0 += 32) {
      const int key = k0 + lane;
      const float a = key < P ? er[key] / s : 0.f;
      __syncwarp();                       // the chunk is read: write over it
      ar[key] = __float2bfloat16(a);
    }
  }

  // att v, v(u + 1) loading while v(u) is applied
  const int wm = warp / WN, wn = warp % WN, m0 = 32 * wm;
  const int ntt = C / 8, npw = (ntt + WN - 1) / WN;
  const int n0t = wn * npw, nt = min(npw, ntt - n0t);
  const bf16* att = reinterpret_cast<const bf16*>(es);
  const int lda = 2 * lde;
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  for (int u = 0; u < nsub; ++u) {
    mma3::cp_wait<0>();
    __syncthreads();                      // v(u) (and the attention) are in
    if (u + 1 < nsub) issue_v(u + 1);
    if (nt <= 0) continue;
    mma_rows2_bf16<NT>(acc, att + m0 * lda + u * vk, lda,
                       vs + (u & 1) * vstage + 8 * n0t, ldv, vk, nt, lane);
  }
  store_pam<bf16, NT>(acc, g, x, out, static_cast<size_t>(q0) * C, C, m0,
                      n0t, nt, nq);
}

// ------------------------------------------------------- the bf16 CAM
//
// In bf16 the CAM is three launches. The gram launch forms each symmetric
// pair once: a block per tile (i-block, j-block >= i-block) of TI x TI
// gram elements, each one chain of f32 FMAs over p = 0 .. P - 1 in order
// (never split over positions), written at (i, j) and mirrored at (j, i)
// of a [B, C, C] f32 scratch. x[p, i] x[p, j] and x[p, j] x[p, i] are the
// same exact product, so the mirror is the chain of (j, i) bit for bit.
// The tile's rows come in kGramKP positions a stage (cp.async, two stages
// ahead) and stay bf16 in shared memory: each of the 64 threads reads its
// R rows and R columns of a position as one 128-bit load each (R = TI /
// 8), widens them in registers and forms an R x R register tile of FMAs.
// Widened to f32 in shared memory once a stage instead, the gram launch
// took 0.248 against 0.212 ms at C = 512, P = 475, B = 48 (H100 80GB
// HBM3, 700 W): the widening's shared loads and stores waited behind the
// FMA loop's, which keep the shared memory pipe busy; 64 x 32 tiles (more
// blocks, fewer waves lost) were 13% slower. The softmax launch then turns
// each gram row into bf16 attention, and the apply launch forms x att^T +
// x as a GEMM.

constexpr int kGramThreads = 64;
constexpr int kGramKP = 32;               // positions a stage
constexpr int kGramStages = 3;            // stages in flight

// The gram launch's tiles: TI x TI, TI = 32 up to C = 128 (more blocks for
// the SMs), else 64 (an 8 x 8 register tile a thread).
__host__ __device__ inline int gram_tile(int C) { return C <= 128 ? 32 : 64; }
template <int TI>
__host__ __device__ constexpr size_t gram_bytes() {
  return static_cast<size_t>(kGramStages) * 2 * kGramKP * TI * 2;
}
__host__ __device__ inline int gram_blocks(int C) {
  const int nb = (C + gram_tile(C) - 1) / gram_tile(C);
  return nb * (nb + 1) / 2;
}

template <int TI>
__global__ void __launch_bounds__(kGramThreads)
dual_attention_cam_gram(const bf16* __restrict__ xc, float* __restrict__ gram,
                        int P, int C) {
  constexpr int R = TI / 8;               // a thread's rows and columns
  constexpr int kStage = 2 * kGramKP * TI;        // elements of a stage
  extern __shared__ __align__(16) unsigned char sm[];
  const int nb = (C + TI - 1) / TI;
  int bi = 0, rest = blockIdx.x;
  while (rest >= nb - bi) {
    rest -= nb - bi;
    ++bi;
  }
  const int bj = bi + rest, i0 = bi * TI, j0 = bj * TI;
  const bool diag = bi == bj;
  const int ni = min(TI, C - i0), nj = min(TI, C - j0);
  const bf16* x = xc + static_cast<size_t>(blockIdx.y) * P * C;
  bf16* raw = reinterpret_cast<bf16*>(sm);    // [stages][2][KP][TI]
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int nst = (P + kGramKP - 1) / kGramKP;

  // stage st's rows into its slot, i columns then j columns, one commit
  // group (empty past P); columns past C are never copied and feed only
  // products that are not stored
  auto issue = [&](int st) {
    const int p0 = st * kGramKP, np = max(0, min(kGramKP, P - p0));
    bf16* dst = raw + (st % kGramStages) * kStage;
    for (int o = 0; o < (diag ? 1 : 2); ++o) {
      const int c0 = o ? j0 : i0, n = o ? nj : ni;
      for (int i = tid; i < np * (TI / 8); i += kGramThreads) {
        const int p = i / (TI / 8), c = 8 * (i % (TI / 8));
        if (c < n) {
          mma3::cp16(dst + (o * kGramKP + p) * TI + c,
                     x + static_cast<size_t>(p0 + p) * C + c0 + c);
        }
      }
    }
    mma3::cp_commit();
  };
  // R bf16 values at p (one 128-bit load at TI = 64) widened to f32 in
  // registers, each then a factor of R FMAs
  auto get = [](float (&v)[R], const bf16* p) {
    uint32_t w[R / 2];
    if constexpr (R == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    }
#pragma unroll
    for (int h = 0; h < R / 2; ++h) {
      v[2 * h] = __uint_as_float(w[h] << 16);
      v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
    }
  };

  float acc[R][R];
  zero_acc(acc);
  for (int st = 0; st < kGramStages - 1; ++st) issue(st);
  for (int st = 0; st < nst; ++st) {
    mma3::cp_wait<kGramStages - 2>();
    __syncthreads();                      // stage st is in; st - 1 is read
    issue(st + kGramStages - 1);          // into the slot stage st - 1 left
    const bf16* slot = raw + (st % kGramStages) * kStage;
    const bf16* fa = slot + R * ty;
    const bf16* fb = slot + (diag ? 0 : kGramKP * TI) + R * tx;
    const int np = min(kGramKP, P - st * kGramKP);
#pragma unroll 4
    for (int p = 0; p < np; ++p) {
      float a[R], b[R];
      get(a, fa + p * TI);
      get(b, fb + p * TI);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  mma3::cp_wait<0>();                     // the empty groups past P

  // G[i, j] and, off the diagonal, its mirror G[j, i]: a thread's rows
  // R ty .. R ty + R - 1 and columns R tx .. are each contiguous
  float* gr = gram + static_cast<size_t>(blockIdx.y) * C * C;
  const int i = R * ty, j = R * tx;
  if (i >= ni || j >= nj) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4* d = reinterpret_cast<float4*>(
        gr + static_cast<size_t>(i0 + i + r) * C + j0 + j);
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      d[h] = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                         acc[r][4 * h + 3]);
    }
  }
  if (diag) return;
#pragma unroll
  for (int c = 0; c < R; ++c) {
    float4* d = reinterpret_cast<float4*>(
        gr + static_cast<size_t>(j0 + j + c) * C + i0 + i);
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      d[h] = make_float4(acc[4 * h][c], acc[4 * h + 1][c], acc[4 * h + 2][c],
                         acc[4 * h + 3][c]);
    }
  }
}

// The softmax launch: a warp per gram row (of all B C rows), its softmax
// of rowmax - G in registers (lane l: columns l + 32 u), rounded to bf16
// and written over the front of the same row: att [B][C][2 C] in bf16.
template <int MC>
__global__ void __launch_bounds__(kThreads)
dual_attention_cam_softmax(float* __restrict__ gram, int C, int rows) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float* gr = gram + static_cast<size_t>(row) * C;
  float e[MC / 32];
#pragma unroll
  for (int u = 0; u < MC / 32; ++u) {
    const int j = lane + 32 * u;
    e[u] = j < C ? gr[j] : 0.f;
  }
  // the row is in registers (softmax_row's shuffles follow every load)
  softmax_row(e, C, C, true, reinterpret_cast<bf16*>(gr), lane);
}

// The apply launch: y = gc x att^T + x, a GEMM of x [P, C] by att [C, C]^T
// per batch row on the tensor cores. A block takes a tile of BM positions
// by kApplyBN CAM columns (blockIdx.x, .y; batch row .z): BM = 128 past P
// = 192, where a tile reads half the bytes for its products, else 64. Its
// 8 warps take 32 x 32 (BM = 64) or 32 x 64 (BM = 128) each, in mma.sync
// m16n8k16 tiles, K in chunks of kApplyBK columns, kApplyStages in flight
// (cp.async), the fragments read by ldmatrix. Each output sums its
// 16-column steps in order from k = 0, as one product over K = C would.
constexpr int kApplyBN = 128, kApplyBK = 32;
constexpr int kApplyStages = 4;
constexpr int kApplyLd = kApplyBK + 8;    // a stage's row stride (80 B)

__host__ __device__ inline int apply_rows(int P) { return P > 192 ? 128 : 64; }
__host__ __device__ inline size_t apply_bytes(int P) {
  return static_cast<size_t>(kApplyStages) * (apply_rows(P) + kApplyBN) *
         kApplyLd * 2;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
dual_attention_cam_apply(const bf16* __restrict__ xc,
                         const float* __restrict__ gram,
                         const bf16* __restrict__ gc, bf16* __restrict__ outc,
                         int P, int C) {
  constexpr int kWN = kWarps / (BM / 32);         // warps along the columns
  constexpr int NT = kApplyBN / kWN / 8;          // n-tiles a warp: 4 or 8
  constexpr int kStage = (BM + kApplyBN) * kApplyLd;    // elements
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* st = reinterpret_cast<bf16*>(sm);
  const size_t ov = static_cast<size_t>(blockIdx.z) * P * C;
  const bf16* x = xc + ov;
  bf16* out = outc + ov;
  const int lda = 2 * C;                  // att rows over the gram's
  const bf16* att = reinterpret_cast<const bf16*>(
      gram + static_cast<size_t>(blockIdx.z) * C * C);
  const int p0 = blockIdx.x * BM, i0 = blockIdx.y * kApplyBN;
  const int np = min(BM, P - p0), ni = min(kApplyBN, C - i0);
  const int nst = C / kApplyBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp / kWN), wn = 8 * NT * (warp % kWN);

  // stage s: columns kApplyBK s .. of the block's x rows and att rows, one
  // commit group (empty past the last); rows past P or C stay as they
  // are, and only feed outputs that are not stored
  auto issue = [&](int s) {
    if (s < nst) {
      bf16* a = st + (s % kApplyStages) * kStage;
      mma3::load_rows16(a, kApplyLd, x + static_cast<size_t>(p0) * C, np,
                        kApplyBK, C, s * kApplyBK, kThreads);
      mma3::load_rows16(a + BM * kApplyLd, kApplyLd,
                        att + static_cast<size_t>(i0) * lda, ni, kApplyBK,
                        lda, s * kApplyBK, kThreads);
    }
    mma3::cp_commit();
  };
  for (int s = 0; s < kApplyStages - 1; ++s) issue(s);

  // a lane's ldmatrix rows and columns: x rows (l & 7) (+ 8), the second 8
  // columns for lanes 16-31; att rows (l & 7) (+ 8 for lanes 16-31), the
  // second 8 columns for lanes 8-15 and 24-31
  const int xrow = (lane & 7) + 8 * ((lane >> 3) & 1), xcol = 8 * (lane >> 4);
  const int arow = (lane & 7) + 8 * (lane >> 4), acol = 8 * ((lane >> 3) & 1);
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  for (int s = 0; s < nst; ++s) {
    mma3::cp_wait<kApplyStages - 2>();
    __syncthreads();                      // stage s is in; s - 1 is read
    issue(s + kApplyStages - 1);
    const bf16* a = st + (s % kApplyStages) * kStage;
    const bf16* bt = a + BM * kApplyLd;
#pragma unroll
    for (int k = 0; k < kApplyBK; k += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4(af[mi], a + (wm + 16 * mi + xrow) * kApplyLd + k + xcol);
      }
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, bt + (wn + 16 * nj + arow) * kApplyLd + k + acol);
        const uint32_t b0[2] = {bfr[0], bfr[1]}, b1[2] = {bfr[2], bfr[3]};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], b0);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], b1);
        }
      }
    }
  }
  mma3::cp_wait<0>();                     // the empty groups past the end

  // y[p, i] = g acc + x[p, i]
  const float g = to_f32(gc[0]);
  const int g4 = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm + 16 * mi + g4 + 8 * h;
      if (p >= np) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int i = wn + 8 * nt + t2;
        if (i >= ni) continue;
        const size_t at = static_cast<size_t>(p0 + p) * C + i0 + i;
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(x + at);
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(g * acc[mi][nt][2 * h] + __low2float(r),
                                  g * acc[mi][nt][2 * h + 1] + __high2float(r));
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

// The wide f32 kernel's CAM blocks: block (j, b) takes columns 32 j ..
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

// f32 up to C = 128, two blocks an SM (128 registers): with up to 207
// registers one block held an SM and the bf16 kernel of that design ran
// 30-55% slower at C = 512 (H100 80GB HBM3, 700 W).
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

// The kept-energies PAM blocks (bf16): block (j, b) takes query tile j
// (QT rows) of batch row b over all C columns; QT = 32 up to C = 128, so
// that two blocks share an SM at P = 475 (64-query tiles, one an SM, made
// C = 128, P = 475 0.151 against 0.125 ms; H100 80GB HBM3, 700 W), else 64.
template <int QT, int NT, int NTH>
__global__ void __launch_bounds__(NTH, QT == 32 ? 2 : 1)
dual_attention_pam_kept(const bf16* __restrict__ xp, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ gp, bf16* __restrict__ outp,
                        int P, int C, int D) {
  extern __shared__ __align__(16) unsigned char sm[];
  const size_t ov = static_cast<size_t>(blockIdx.y) * P * C;
  const size_t oq = static_cast<size_t>(blockIdx.y) * P * D;
  pam_kept<QT, NT, NTH>(xp + ov, q + oq, k + oq, v + ov, to_f32(gp[0]),
                        outp + ov, P, C, D, QT * blockIdx.x, sm);
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
// range, or the wide f32 kernel's CAM tile rows, and the dynamic shared
// memory of one (CAM) block.
struct Plan {
  int tp, pam_cols;
  size_t smem;
};

template <typename T>
Plan plan(int B, int P, int C, int D) {
  Plan pl{P, C, 0};
  if (narrow(P, C)) {
    pl.pam_cols = few_blocks(B, C) ? kGroup : C;
    pl.smem = smem_bytes<T>(P, C, D);
  } else if constexpr (sizeof(T) == 4) {
    pl.tp = cam_bufs(P) > 1 ? tile_rows(C) : P;
    pl.smem = wide_cam_bytes<T>(P, pl.tp, C);
  }
  return pl;
}

// One kernel launch of a call: its kernel, grid, threads and dynamic shared
// memory, and its kind (what dual_attention_launch_info reports).
enum Kind {
  kNarrowLaunch, kCamF32, kPamWalks, kPamKept, kCamGram, kCamSoftmax,
  kCamApply
};
struct Spec {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
  int kind;
};
constexpr int kMaxLaunches = 4;

// The PAM launch of the wide kernel: in bf16 the kept energies where a
// block's regions fit the card's shared memory, else the walks.
template <typename T>
Spec pam_spec(int B, int P, int C, int D) {
  if constexpr (sizeof(T) == 2) {
    const void* fn = nullptr;
    int qt = 64, threads = kThreads;
    if (C <= kNarrowC) {
      fn = reinterpret_cast<const void*>(dual_attention_pam_kept<32, 2, kThreads>);
      qt = 32;
    } else if (C <= 256) {
      fn = reinterpret_cast<const void*>(dual_attention_pam_kept<64, 8, kThreads>);
    } else {
      fn = reinterpret_cast<const void*>(dual_attention_pam_kept<64, 8, 2 * kThreads>);
      threads = 2 * kThreads;
    }
    const size_t smem = kept_bytes(P, C, D, qt, threads / (4 * qt));
    if (smem <= fork2::smem_optin()) {
      return {fn, dim3((P + qt - 1) / qt, B), threads, smem, kPamKept};
    }
  }
  const void* fn;
  int threads = kThreads;
  if (C <= kNarrowC) {
    fn = reinterpret_cast<const void*>(dual_attention_pam_tiles<T, 4, kThreads>);
  } else if (C <= 256) {
    fn = reinterpret_cast<const void*>(dual_attention_pam_tiles<T, 8, kThreads>);
  } else {
    fn = reinterpret_cast<const void*>(dual_attention_pam_tiles<T, 8, 2 * kThreads>);
    threads = 2 * kThreads;
  }
  return {fn, dim3((P + kTileQ - 1) / kTileQ, B), threads, tiles_bytes<T>(C, D),
          kPamWalks};
}

// Every launch of a call on B rows, in the order they are issued (the PAM
// launch first, onto the side stream): the narrow kernel; or the wide
// PAM launch and its CAM launch (f32), or its gram, softmax and apply
// launches (bf16). Returns their number.
template <typename T>
int specs(int B, int P, int C, int D, Spec (&sp)[kMaxLaunches]) {
  const Plan pl = plan<T>(B, P, C, D);
  if (narrow(P, C)) {
    sp[0] = {reinterpret_cast<const void*>(dual_attention_kernel<T>),
             dim3(C / kGroup + C / pl.pam_cols, B), kThreads, pl.smem,
             kNarrowLaunch};
    return 1;
  }
  sp[0] = pam_spec<T>(B, P, C, D);
  if constexpr (sizeof(T) == 4) {
    const void* fn = C <= kNarrowC
        ? reinterpret_cast<const void*>(dual_attention_wide_kernel<float, kNarrowC>)
        : reinterpret_cast<const void*>(dual_attention_wide_f32);
    sp[1] = {fn, dim3(C / kGroup, B), kThreads, pl.smem, kCamF32};
    return 2;
  } else {
    const bool small = gram_tile(C) == 32;
    sp[1] = {small ? reinterpret_cast<const void*>(dual_attention_cam_gram<32>)
                   : reinterpret_cast<const void*>(dual_attention_cam_gram<64>),
             dim3(gram_blocks(C), B), kGramThreads,
             small ? gram_bytes<32>() : gram_bytes<64>(), kCamGram};
    const void* softmax = C <= kNarrowC
        ? reinterpret_cast<const void*>(dual_attention_cam_softmax<kNarrowC>)
        : reinterpret_cast<const void*>(dual_attention_cam_softmax<kMaxC>);
    sp[2] = {softmax, dim3((B * C + kWarps - 1) / kWarps), kThreads, 0,
             kCamSoftmax};
    const int bm = apply_rows(P);
    sp[3] = {bm == 128 ? reinterpret_cast<const void*>(dual_attention_cam_apply<128>)
                       : reinterpret_cast<const void*>(dual_attention_cam_apply<64>),
             dim3((P + bm - 1) / bm, (C + kApplyBN - 1) / kApplyBN, B),
             kThreads, apply_bytes(P), kCamApply};
    return 4;
  }
}

cudaError_t opt_in(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launches sp on stream s with the kernel's arguments a (of its parameter
// types exactly).
template <typename... A>
int go(const Spec& sp, cudaStream_t s, A... a) {
  cudaError_t err = opt_in(sp.fn, sp.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a...};
  return static_cast<int>(
      cudaLaunchKernel(sp.fn, sp.grid, dim3(sp.threads), args, sp.smem, s));
}

// C <= 128 and P <= 64 (resnet18/34 at 144x256, the main path) run the
// narrow kernel; a wider C or P the wide one: its PAM launch forked
// beside its CAM launches. sides 1: the CAM side alone (bf16: the gram,
// softmax and apply launches), 2: the PAM launch alone, 3: both; bf16 also
// 4: the gram launch alone, 8: the softmax launch alone (on the gram a gram
// launch left), 16: the apply launch alone (on the attention a softmax
// launch left). scratch: the bf16 gram, [B, C, C] f32.
template <typename T>
int launch(const void* xp, const void* q, const void* k, const void* v,
           const void* gp, const void* xc, const void* gc, void* outp,
           void* outc, void* scratch, int B, int P, int C, int D, int sides,
           void* stream) {
  const int most = sizeof(T) == 2 ? 31 : 3;
  if (!takes(P, C, D) || sides < 1 || sides > most) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* x_p = static_cast<const T*>(xp);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_p = static_cast<const T*>(gp);
  const T* x_c = static_cast<const T*>(xc);
  const T* g_c = static_cast<const T*>(gc);
  T* o_p = static_cast<T*>(outp);
  T* o_c = static_cast<T*>(outc);
  float* gram = static_cast<float*>(scratch);
  Spec sp[kMaxLaunches];
  specs<T>(B, P, C, D, sp);
  if (narrow(P, C)) {
    if (sides != 3) return static_cast<int>(cudaErrorInvalidValue);
    return go(sp[0], st, x_p, q_, k_, v_, g_p, x_c, g_c, o_p, o_c, P, C, D,
              plan<T>(B, P, C, D).pam_cols);
  }
  const bool cam = (sides & ~2) != 0;
  if (sizeof(T) == 2 && cam && gram == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = 0;
  if (!((sides & 2) && cam)) {
    // one side alone, on the caller's stream
    if (sides & 2) return go(sp[0], st, x_p, q_, k_, v_, g_p, o_p, P, C, D);
    if constexpr (sizeof(T) == 4) {
      return go(sp[1], st, x_c, g_c, o_c, P, C, plan<T>(B, P, C, D).tp);
    } else {
      if (sides & 5) err = go(sp[1], st, x_c, gram, P, C);
      if (!err && (sides & 9)) err = go(sp[2], st, gram, C, B * C);
      if (!err && (sides & 17)) {
        err = go(sp[3], st, x_c, static_cast<const float*>(gram), g_c, o_c, P,
                 C);
      }
      return err;
    }
  }
  // both sides, forked from the caller's stream st and joined back on
  // every path once forked
  fork2::Side* sd = nullptr;
  if constexpr (sizeof(T) == 4) {
    // the PAM launch on a side stream beside the CAM launch
    err = static_cast<int>(fork2::fork(st, &sd));
    if (err) return err;
    err = go(sp[0], sd->stream, x_p, q_, k_, v_, g_p, o_p, P, C, D);
    if (!err) err = go(sp[1], st, x_c, g_c, o_c, P, C, plan<T>(B, P, C, D).tp);
    const int joined = static_cast<int>(fork2::join(st, sd));
    return err ? err : joined;
  } else {
    // the gram launch on a side stream of the greatest priority, so that
    // its blocks take the SMs before the PAM launch's, which hold a whole
    // SM or half of one: dispatched after them, the gram was starved and
    // the CAM's launches finished last (C = 128, P = 475 in a CUDA graph:
    // 0.200 against 0.125 ms; P = 144: 0.056 against 0.028; issued one by
    // one, calls whose PAM blocks went first took 200 against 120 us;
    // H100 80GB HBM3, 700 W). The softmax and apply launches follow the
    // gram on a default-priority side stream: at the greatest priority too
    // they held back the PAM, the longer side at C = 128 (in a graph 0.120
    // against 0.111 ms).
    fork2::Side* rest = nullptr;
    err = static_cast<int>(fork2::fork(st, &sd, true));
    if (err) return err;
    err = go(sp[1], sd->stream, x_c, gram, P, C);
    if (!err) err = static_cast<int>(fork2::fork(sd->stream, &rest));
    if (!err) err = go(sp[0], st, x_p, q_, k_, v_, g_p, o_p, P, C, D);
    if (!err) err = go(sp[2], rest->stream, gram, C, B * C);
    if (!err) {
      err = go(sp[3], rest->stream, x_c, static_cast<const float*>(gram), g_c,
               o_c, P, C);
    }
    int joined = static_cast<int>(fork2::join(st, sd));
    if (rest != nullptr) {
      const int j2 = static_cast<int>(fork2::join(st, rest));
      if (!joined) joined = j2;
    }
    return err ? err : joined;
  }
}

}  // namespace

extern "C" int dual_attention_f32(const void* xp, const void* q, const void* k,
                                  const void* v, const void* gp,
                                  const void* xc, const void* gc, void* outp,
                                  void* outc, void* scratch, int B, int P,
                                  int C, int D, void* stream) {
  return launch<float>(xp, q, k, v, gp, xc, gc, outp, outc, scratch, B, P, C,
                       D, 3, stream);
}

extern "C" int dual_attention_bf16(const void* xp, const void* q,
                                   const void* k, const void* v,
                                   const void* gp, const void* xc,
                                   const void* gc, void* outp, void* outc,
                                   void* scratch, int B, int P, int C, int D,
                                   void* stream) {
  return launch<bf16>(xp, q, k, v, gp, xc, gc, outp, outc, scratch, B, P, C,
                      D, 3, stream);
}

// One side of the wide kernel alone (sides as in launch; bf16_in != 0: the
// bf16 kernel), which chip_smoke.py times to see which side and launch
// sets a shape's pace; the other side's output is left unwritten. Refuses
// (cudaErrorInvalidValue) a shape of the narrow kernel.
extern "C" int dual_attention_side(const void* xp, const void* q,
                                   const void* k, const void* v,
                                   const void* gp, const void* xc,
                                   const void* gc, void* outp, void* outc,
                                   void* scratch, int B, int P, int C, int D,
                                   int sides, int bf16_in, void* stream) {
  return bf16_in ? launch<bf16>(xp, q, k, v, gp, xc, gc, outp, outc, scratch,
                                B, P, C, D, sides, stream)
                 : launch<float>(xp, q, k, v, gp, xc, gc, outp, outc, scratch,
                                 B, P, C, D, sides, stream);
}

// Bytes of dynamic shared memory of the largest block of a launch of B
// rows (bf16_in != 0: the bf16 kernel), which chip_smoke.py reports beside
// the kernel's times; -1 for a shape the kernel does not take.
extern "C" long long dual_attention_smem_bytes(int B, int P, int C, int D,
                                               int bf16_in) {
  if (!takes(P, C, D)) return -1;
  Spec sp[kMaxLaunches];
  const int n = bf16_in ? specs<bf16>(B, P, C, D, sp) : specs<float>(B, P, C, D, sp);
  size_t b = 0;
  for (int i = 0; i < n; ++i) b = sp[i].smem > b ? sp[i].smem : b;
  return static_cast<long long>(b);
}

// What each launch of a call on B rows is, in issue order, six figures a
// launch into out (at most `room` launches): its kind (0 the narrow
// kernel, 1 the f32 CAM blocks, 2 the PAM walks, 3 the kept-energies PAM,
// 4 the bf16 gram, 5 its softmax, 6 the bf16 CAM apply), threads a block,
// blocks, dynamic shared memory a block, registers a thread
// (cudaFuncGetAttributes) and blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the number of
// launches, or minus a CUDA error code.
extern "C" int dual_attention_launch_info(int B, int P, int C, int D,
                                          int bf16_in, long long* out,
                                          int room) {
  if (!takes(P, C, D)) return -static_cast<int>(cudaErrorInvalidValue);
  Spec sp[kMaxLaunches];
  const int n = bf16_in ? specs<bf16>(B, P, C, D, sp) : specs<float>(B, P, C, D, sp);
  for (int i = 0; i < n && i < room; ++i) {
    cudaFuncAttributes attr;
    int blocks = 0;
    cudaError_t err = opt_in(sp[i].fn, sp[i].smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, sp[i].fn);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sp[i].fn, sp[i].threads, sp[i].smem);
    }
    if (err != cudaSuccess) return -static_cast<int>(err);
    long long* o = out + 6 * i;
    o[0] = sp[i].kind;
    o[1] = sp[i].threads;
    o[2] = static_cast<long long>(sp[i].grid.x) * sp[i].grid.y * sp[i].grid.z;
    o[3] = static_cast<long long>(sp[i].smem);
    o[4] = attr.numRegs;
    o[5] = blocks;
  }
  return n;
}
