// Backward of the fused position (PAM) and channel (CAM) attention of the
// DANet head, f32: per batch row, a thread-block cluster of CAM blocks and
// one PAM block, every product on the tensor cores in 3xTF32. Two kernels:
// the first (below) for P <= 64, C <= 128, D <= 32, the main path's heads
// (resnet18/34 at 144x256); the wide one ("wide kernel" below) for the
// rest of the domain the wrapper takes, P <= 256, C <= 512, D <= 64.
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
//     dx_c = dy + gc dy Bm - x dN - x dN^T.
//   The rowmax shift has no gradient (a softmax row is shift-invariant).
// A and Bm are recomputed from the inputs, not saved by the forward.
//
// What bounds it on an H100: at the trainer's shapes (P = 40, C = 128,
// D = 16, B = 48) it must move 6.4 MB (six [P, C] or [P, D] inputs read,
// four written) and do 0.27 GFLOP, 4.6 MFLOP a row of it in CAM's C x C x P
// products (the symmetric Gram x^T x counted once per pair): 4.0 us as f32
// FMA at 67 TFLOP/s, 1.6 us as three tf32 products at 495 TFLOP/s, 1.9 us
// of bytes at 3.35 TB/s. In practice it is bound by the latency of each
// block's chain of phases.
//
// What the first design lost (0.0675 ms at B = 48 on an H100 80GB HBM3 at
// 700 W, 17x its operations bound): a grid of (2, B) blocks of 512
// threads, block 0 of a row doing all of CAM and block 1 PAM. The CAM
// block kept the full G / Bm and H / dN, two C x (C + 1) f32 matrices,
// beside x and dy: 169 KB, one block an SM, and the 48 CAM blocks (2.6 M
// FMA each against PAM's 0.5 M) the critical path. Every product was a
// chain of FMAs on the CUDA cores with both operands loaded from shared
// memory on every step (8 loads for 16 FMA), which capped a block at about
// a quarter of the FMA rate, and the tensor cores sat idle.
//
// Design of the first kernel (0.0216 ms at B = 48, same card):
// - Grid (nc, B + ceil(B / nc)) of 256-thread blocks, nc = C / 32 (1-4),
//   launched with cudaLaunchKernelEx in clusters of (nc, 1, 1). Row y < B
//   is batch row y's CAM cluster; the rows after it hold one PAM block per
//   batch row, nc to a cluster, which never synchronise.
// - CAM rank r owns the Gram rows I_r = [32 r, 32 r + 32): G_r =
//   x[:, I_r]^T x and H_r = dy[:, I_r]^T x, [32, C] each (one pass over x
//   feeds both), their row softmax and chain rule into gc Bm_r and dN_r in
//   its shared memory (a warp holds four whole rows in registers). Then
//     dx_c[:, I_r] = dy[:, I_r] + sum_s T_s[:, I_r] - x dN_r^T,
//   T_s = dy[:, I_s] gc Bm_s - x[:, I_s] dN_s, [P, C]. x dN_r^T needs only
//   rank r's rows of dN and stays in registers; rank s stores columns I_q
//   of T_s into slot s of rank q's receive buffer through distributed
//   shared memory (st to map_shared_rank), and after a cluster barrier
//   each rank sums its slots in rank order. No atomics, and no rank reads
//   another's memory after the barrier, so none waits for its peers to
//   exit; a barrier arrival at the start, waited for before the first
//   remote store, makes sure every peer has started.
// - The PAM block does E, G, their softmax and chain rule (rows in
//   registers, as in CAM), then dv, dq and dk. Splitting it in two (dv in
//   a block of its own) shortened it alone, but the 48 more blocks at
//   B = 48 no longer ran in one wave, and it measured slower.
// - Products: mma.sync.m16n8k8 with tf32 operands in 3xTF32: a = hi + lo,
//   hi = a rounded to tf32 (cvt.rna's rounding, done with integer
//   operations, which measured faster than cvt), lo = a - hi, exact in f32
//   and truncated to tf32 by the tensor cores; a tile accumulates
//   lo hi + hi lo + hi hi in f32, within a few 1e-6 of each gradient's
//   scale on the card, as f32 FMA. Plain TF32 is not enough: CAM's softmax
//   reads rowmax(G) - G with |G| in the tens, so a relative error of 1e-3
//   in G moves Bm by percents. Operands stay f32 in shared memory and are
//   split as they are loaded into fragments. Ragged edges (P not a
//   multiple of 16, K not of 8, D < 8) are clamped or masked in the loads,
//   so no buffer is padded; the [*, P] products (x dN_r^T, dv) run
//   transposed, P on the n8 axis, where P = 40 is five tiles without
//   padding. Tiles of one or two m16n8 outputs keep four accumulator sets
//   (small terms apart, odd k steps apart) so that a warp is not bound by
//   the latency of one chain of mma. wgmma is not used: these products are
//   32- to 64-row slabs with K of 32-128, below its 64-row warpgroup tile.
// - Shared memory per block, the CAM rank's: x ([P, C + 4]), dy[:, I_r]
//   ([P, 36]), gc Bm_r and dN_r ([32, C + 4] each) and the receive buffer
//   ([nc, P, 36]): 82 KB at P = 40, C = 128. Registers (up to 128 a
//   thread) allow two blocks an SM, so that the 240 blocks of B = 48 run
//   in one wave (62 clusters of 4 can be resident).
// - The gamma gradients sum B * P * C terms. Each block reduces its share
//   in a fixed order (per warp by shuffles, then the warps in order) and
//   writes one value; the wrapper sums the [2, B nc] shares (PAM's padded
//   with zeros) over the last axis in one reduction, so the result does
//   not change from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;        // Gram rows of one CAM rank
constexpr int kNarrowC = 128;    // what the narrow kernel takes
constexpr int kNarrowP = 64;
constexpr int kNarrowD = 32;
constexpr int kMaxC = 512;       // what the wide kernel takes (the wrapper's
constexpr int kMaxP = 256;       // limits)
constexpr int kMaxD = 64;
constexpr int kMaxRanks = 8;     // a portable cluster
constexpr int kCC = 128;         // channels of a slab of dy and v (wide PAM)

// A row stride of at least n words, a multiple of 4 (16-byte rows) and
// 4 mod 8, so that the 8 x 4 lanes of a fragment load along rows hit
// distinct banks.
__host__ __device__ constexpr int ld4(int n) {
  return (n + 3) / 4 * 4 + ((n + 3) / 4 * 4 % 8 ? 0 : 4);
}

__host__ __device__ inline size_t cam_floats(int P, int C) {
  return static_cast<size_t>(P) * (ld4(C) + (1 + C / kRows) * ld4(kRows)) +
         2 * static_cast<size_t>(kRows) * ld4(C);
}
__host__ __device__ inline size_t pam_floats(int P, int C, int D) {
  return 2 * static_cast<size_t>(P) * ld4(D) +
         2 * static_cast<size_t>(P) * ld4(C) +
         2 * static_cast<size_t>(P) * ld4(P);
}
size_t smem_bytes(int P, int C, int D) {
  const size_t a = cam_floats(P, C), b = pam_floats(P, C, D);
  return (a > b ? a : b) * sizeof(float);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// Asynchronous copies from global into shared memory (cp.async), all
// issued before any is waited for.
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Columns [c0, c0 + cols) of a [rows, C] row-major f32 array in global
// memory into shared memory with row stride ld (cols, c0 and C multiples
// of 4, 16-byte aligned).
__device__ void load_rows4(float* dst, int ld, const float* __restrict__ src,
                           int rows, int cols, int C, int c0) {
  const int c4 = cols / 4;
  for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
    const int r = i / c4, c = (i % c4) * 4;
    cp16(dst + r * ld + c, src + r * C + c0 + c);
  }
}
// A [rows, cols] row-major array, one word at a time.
__device__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                          int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    cp4(dst + (i / cols) * ld + i % cols, src + i);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ------------------------------------------------------- 3xTF32 tiles

// a = hi + lo: hi is a rounded to tf32 (to nearest, ties away from zero:
// cvt.rna.tf32.f32, done here with integer operations), lo = a - hi is
// exact in f32 and passed as it is: the tensor cores read the 19 high bits
// of a tf32 operand, which truncates lo to tf32.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: tf32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand in shared memory: element (i, k) at p[i * si + k * sk], i
// the row of A or the column of B, valid for i < n (indices past n are
// clamped into range: they feed only products that are never stored).
struct View {
  const float* p;
  int si, sk, n;
};

// One warp: acc[i][j] += A_i[m0_i .. m0_i + 16) x B[.., n0 + 8 j ..
// n0 + 8 j + 8) for i < mt (<= MT) and j < nt (<= NT), the other tiles
// skipped, over k < K in 3xTF32 (the A_i negated with kNeg). The m-tiles
// share each B fragment and the n-tiles each A fragment; the A_i may be
// different operands. K is stepped by 8, the last step masked to zeros
// past K. Fragments of m16n8k8.tf32, lane l = 4 g + t: A (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (t, g), (t + 4, g); acc
// (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8, 2 t + 1). Each lane walks
// fixed row pointers. With fewer than four tiles a tile has four
// accumulators (hi hi and the small terms lo hi + hi lo apart, odd k steps
// apart from even ones), added at the end, so that the warp is not bound
// by the latency of one chain of mma.
template <int MT, int NT, bool kNeg = false>
__device__ __forceinline__ void warp_mma3(float (&acc)[MT][NT][4],
                                          const View (&a)[MT],
                                          const int (&m0)[MT], int mt, View b,
                                          int n0, int K, int nt = NT) {
  constexpr bool kSplit = MT * NT < 4;
  constexpr int kSets = kSplit ? 4 : 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ra[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    ra[i][0] = a[i].p + min(m0[i] + g, a[i].n - 1) * a[i].si;
    ra[i][1] = a[i].p + min(m0[i] + g + 8, a[i].n - 1) * a[i].si;
  }
  const float* rb[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) rb[j] = b.p + min(n0 + 8 * j + g, b.n - 1) * b.si;
  // set 0: hi hi of even steps (acc itself when not split), 1: hi hi of
  // odd steps, 2 and 3: the small terms of even and odd steps
  float part[kSets - 1 > 0 ? kSets - 1 : 1][MT][NT][4] = {};
  // one k step: the lane's k indices (k + t and k + t + 4, clamped into
  // range) and whether each is inside K
  auto step = [&](int odd, int k0, int k1, bool v0, bool v1) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mt) break;
      const int a0 = k0 * a[i].sk, a1 = k1 * a[i].sk;
      float av[4] = {ra[i][0][a0], ra[i][1][a0], ra[i][0][a1], ra[i][1][a1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (e < 2 ? v0 : v1) ? av[e] : 0.f;
        split_tf32(kNeg ? -x : x, ah[i][e], al[i][e]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      uint32_t bh[2], bl[2];
      split_tf32(v0 ? rb[j][k0 * b.sk] : 0.f, bh[0], bl[0]);
      split_tf32(v1 ? rb[j][k1 * b.sk] : 0.f, bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt) break;
        if (kSplit) {
          float (&big)[4] = odd ? part[0][i][j] : acc[i][j];
          float (&lo)[4] = part[kSplit ? 1 + odd : 0][i][j];
          mma_tf32(lo, al[i], bh);
          mma_tf32(lo, ah[i], bl);
          mma_tf32(big, ah[i], bh);
        } else {
          mma_tf32(acc[i][j], al[i], bh);
          mma_tf32(acc[i][j], ah[i], bl);
          mma_tf32(acc[i][j], ah[i], bh);
        }
      }
    }
  };
  const int kf = K & ~15;
  int k = 0;
  for (; k < kf; k += 16) {
    step(0, k + t, k + t + 4, true, true);
    step(1, k + t + 8, k + t + 12, true, true);
  }
  // at most two steps are left (the second of them masked)
#pragma unroll
  for (int odd = 0; odd < 2; ++odd, k += 8) {
    if (k >= K) break;
    const int c0 = min(k + t, K - 1), c1 = min(k + t + 4, K - 1);
    step(odd, c0, c1, k + t < K, k + t + 4 < K);
  }
  if (kSplit) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = (acc[i][j][e] + part[0][i][j][e]) +
                         (part[kSplit ? 1 : 0][i][j][e] +
                          part[kSplit ? 2 : 0][i][j][e]);
        }
  }
}

// Butterfly max / sum of R values at once over a warp (R independent
// shuffle chains, interleaved).
template <int R>
__device__ __forceinline__ void warp_max_n(float (&v)[R]) {
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = fmaxf(v[r], __shfl_xor_sync(0xffffffffu, v[r], o));
}
template <int R>
__device__ __forceinline__ void warp_sum_n(float (&v)[R]) {
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Calls put(m, n, v) for each element of a warp's acc from warp_mma3 that
// lies inside [0, M) x [0, N).
template <int NT, class Put>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], int m0,
                                           int n0, int M, int N, Put put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
      if (m < M && n < N) put(m, n, acc[j][e]);
    }
}

// ------------------------------------------------------- CAM rank

// CAM rank r of one batch row: columns I_r of dx_c and this rank's share
// of dgc. x, dy, dx: [P, C].
__device__ void cam_rank(const float* __restrict__ x,
                         const float* __restrict__ dy, float g,
                         float* __restrict__ dx, float* __restrict__ dg,
                         int P, int C, int r, int nc, float* sm, float* red) {
  const int ldx = ld4(C), ldr = ld4(kRows);
  const int i0 = kRows * r;
  float* xs = sm;                      // [P][ldx]: x
  float* dr = xs + P * ldx;            // [P][ldr]: dy[:, I_r]
  float* bm = dr + P * ldr;            // [32][ldx]: G_r, then gc Bm_r
  float* dn = bm + kRows * ldx;        // [32][ldx]: H_r, then dN_r
  float* recv = dn + kRows * ldx;      // [nc][P][ldr]: T_q[:, I_r], q < nc
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cluster_arrive();                    // this block has started
  load_rows4(xs, ldx, x, P, C, C, 0);
  load_rows4(dr, ldr, dy, P, kRows, C, i0);
  cp_wait_all();
  __syncthreads();

  // G_r = x[:, I_r]^T x and H_r = dy[:, I_r]^T x, K = P (masked to a
  // multiple of 8), sharing each fragment of x: a warp takes 16 rows by 32
  // columns of both
  for (int item = warp; item < 2 * (C / 32); item += kWarps) {
    const int m0 = 16 * (item & 1), n0 = 32 * (item >> 1);
    float acc[2][4][4];
    zero(acc);
    warp_mma3(acc, {View{xs + i0, 1, ldx, kRows}, View{dr, 1, ldr, kRows}},
              {m0, m0}, 2, View{xs, 1, ldx, C}, n0, P);
    store_tile(acc[0], m0, n0, kRows, C,
               [&](int i, int j, float v) { bm[i * ldx + j] = v; });
    store_tile(acc[1], m0, n0, kRows, C,
               [&](int i, int j, float v) { dn[i * ldx + j] = v; });
  }
  __syncthreads();

  // a warp holds 4 rows, all at once: Bm = softmax(rowmax(G) - G), dgc's
  // share sum(Bm * H), dN = Bm * (gc H - rowsum(gc H * Bm));
  // bm <- gc Bm, dn <- dN
  constexpr int kPer = kNarrowC / 32, kR = kRows / kWarps;
  float dg_part = 0.0f;
  {
    float n[kR][kPer], h[kR][kPer], m[kR], sum[kR], dot[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const float* grow = bm + (warp + kWarps * rr) * ldx;
      m[rr] = -INFINITY;
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int j = lane + 32 * s;
        n[rr][s] = j < C ? grow[j] : 0.f;
        if (j < C) m[rr] = fmaxf(m[rr], n[rr][s]);
      }
    }
    warp_max_n(m);
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const float gmax = m[rr];
      m[rr] = -INFINITY;
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int j = lane + 32 * s;
        n[rr][s] = j < C ? gmax - n[rr][s] : -INFINITY;
        m[rr] = fmaxf(m[rr], n[rr][s]);
      }
    }
    warp_max_n(m);
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      sum[rr] = 0.f;
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int j = lane + 32 * s;
        n[rr][s] = j < C ? expf(n[rr][s] - m[rr]) : 0.f;
        sum[rr] += n[rr][s];
      }
    }
    warp_sum_n(sum);
    float inv[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) inv[rr] = 1.f / sum[rr];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const float* hrow = dn + (warp + kWarps * rr) * ldx;
      dot[rr] = 0.f;
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int j = lane + 32 * s;
        n[rr][s] *= inv[rr];                   // Bm[i][j]
        h[rr][s] = j < C ? hrow[j] : 0.f;
        dg_part = fmaf(n[rr][s], h[rr][s], dg_part);
        dot[rr] = fmaf(g * h[rr][s], n[rr][s], dot[rr]);
      }
    }
    warp_sum_n(dot);
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      float* grow = bm + (warp + kWarps * rr) * ldx;
      float* hrow = dn + (warp + kWarps * rr) * ldx;
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int j = lane + 32 * s;
        if (j < C) {
          grow[j] = g * n[rr][s];
          hrow[j] = n[rr][s] * (g * h[rr][s] - dot[rr]);   // dN[i][j]
        }
      }
    }
  }
  __syncthreads();

  // L^T = dN_r x^T, [32, P], K = C, transposed so that P lies on the n8
  // axis of the tiles (P = 40 is five n-tiles, where it would be three
  // 16-row m-tiles with 8 rows of padding), kept in registers: 16 rows by
  // 16 positions per item, at most 2 x 4 items (one per warp)
  const int nt = (P + 7) / 8, ng = (nt + 1) / 2;
  float acc_l[1][2][4];
  zero(acc_l);
  const bool mine = warp < 2 * ng;
  const int ml = 16 * (warp & 1), nl = 16 * (warp >> 1);
  if (mine) {
    warp_mma3(acc_l, {View{dn, ldx, 1, kRows}}, {ml}, 1, View{xs, ldx, 1, P},
              nl, C, min(2, nt - 2 * (warp >> 1)));
  }

  // T_r = dy[:, I_r] (gc Bm_r) - x[:, I_r] dN_r, [P, C], K = 2 x 32: 16
  // positions by 16 channels per item, each item's columns I_s of one rank
  // s, stored into slot r of rank s's recv through distributed shared
  // memory once every rank has started
  cg::cluster_group cluster = cg::this_cluster();
  const int mt = (P + 15) / 16;
  cluster_wait();
  for (int item = warp; item < mt * (C / 16); item += kWarps) {
    const int m0 = 16 * (item % mt), n0 = 16 * (item / mt);
    float acc[1][2][4];
    zero(acc);
    warp_mma3(acc, {View{dr, ldr, 1, P}}, {m0}, 1, View{bm, 1, ldx, C}, n0,
              kRows);
    warp_mma3<1, 2, true>(acc, {View{xs + i0, ldx, 1, P}}, {m0}, 1,
                          View{dn, 1, ldx, C}, n0, kRows);
    float* to = cluster.map_shared_rank(recv, n0 / kRows) + r * P * ldr -
                (n0 / kRows) * kRows;
    store_tile(acc[0], m0, n0, P, C,
               [&](int p, int j, float v) { to[p * ldr + j] = v; });
  }
  cluster_arrive();                    // this rank's T is sent
  const float total = block_sum(dg_part, red);
  if (threadIdx.x == 0) *dg = total;
  cluster_wait();                      // every rank's T has arrived
  // dx_c[:, I_r] = dy[:, I_r] + (T_0 + T_1 + ...)[:, I_r] - L, the ranks'
  // slices summed in rank order; no rank touches another's shared memory
  // from here on, so none has to wait for its peers to exit
  if (mine) {
    const int g4 = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = ml + g4 + 8 * (e >> 1);
        const int p = nl + 8 * j + t2 + (e & 1);
        if (p < P) {
          float sum = recv[p * ldr + jj];
          for (int q = 1; q < nc; ++q) sum += recv[(q * P + p) * ldr + jj];
          dx[p * C + i0 + jj] = dr[p * ldr + jj] + sum - acc_l[0][j][e];
        }
      }
  }
}

// ------------------------------------------------------- PAM block

// PAM's row softmax and chain rule, rows warp, warp + 8, ... of a warp
// all at once (R of them; rows past `rows` are all zeros and are not
// stored), over P columns (at most 32 kPer):
// A = softmax(E) over as, dE = A * (gp G - rowsum(gp G * A)) over es;
// returns this lane's share of dgp, sum(A * G).
template <int R, int kPer>
__device__ float pam_softmax(float* as, float* es, int rows, int P, int lda,
                             float g, int warp, int lane) {
  float e[R][kPer], m[R], sum[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int p = warp + kWarps * rr;
    const float* arow = as + min(p, rows - 1) * lda;
    m[rr] = -INFINITY;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      e[rr][s] = p < rows && r < P ? arow[r] : -INFINITY;
      m[rr] = fmaxf(m[rr], e[rr][s]);
    }
  }
  warp_max_n(m);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const bool row = warp + kWarps * rr < rows;
    sum[rr] = 0.f;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      e[rr][s] = row && r < P ? expf(e[rr][s] - m[rr]) : 0.f;
      sum[rr] += e[rr][s];
    }
  }
  warp_sum_n(sum);
  float gr[R][kPer], dot[R], dg_part = 0.f;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int p = warp + kWarps * rr;
    const float inv = sum[rr] > 0.f ? 1.f / sum[rr] : 0.f;
    const float* grow = es + min(p, rows - 1) * lda;
    dot[rr] = 0.f;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      e[rr][s] *= inv;                                   // A[p][r]
      gr[rr][s] = p < rows && r < P ? grow[r] : 0.f;
      dg_part = fmaf(e[rr][s], gr[rr][s], dg_part);
      dot[rr] = fmaf(g * gr[rr][s], e[rr][s], dot[rr]);
    }
  }
  warp_sum_n(dot);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int p = warp + kWarps * rr;
    if (p >= rows) continue;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = lane + 32 * s;
      if (r < P) {
        as[p * lda + r] = e[rr][s];
        es[p * lda + r] = e[rr][s] * (g * gr[rr][s] - dot[rr]);   // dE
      }
    }
  }
  return dg_part;
}


// PAM of one batch row: E = q k^T, G = dy v^T, A = softmax(E), this
// row's dgp, dE, then dv = gp A^T dy, dq = dE k and dk = dE^T q.
// q, k, dq, dk: [P, D]; v, dy, dv: [P, C].
__device__ void pam_block(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dy, float g,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, float* __restrict__ dg,
                          int P, int C, int D, float* sm, float* red) {
  const int ldq = ld4(D), ldv = ld4(C), lda = ld4(P);
  float* qs = sm;                      // [P][ldq]
  float* ks = qs + P * ldq;            // [P][ldq]
  float* dys = ks + P * ldq;           // [P][ldv]
  float* as = dys + P * ldv;           // [P][lda]: E, then A
  float* es = as + P * lda;            // [P][lda]: G, then dE
  float* vs = es + P * lda;            // [P][ldv]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_rows(qs, ldq, q, P, D);
  load_rows(ks, ldq, k, P, D);
  load_rows4(dys, ldv, dy, P, C, C, 0);
  load_rows4(vs, ldv, v, P, C, C, 0);
  cp_wait_all();
  __syncthreads();

  // E = q k^T (K = D, masked) and G = dy v^T (K = C): one m16n8 tile of
  // each per item
  const int mt = (P + 15) / 16, nt = (P + 7) / 8;
  for (int item = warp; item < mt * nt; item += kWarps) {
    const int m0 = 16 * (item % mt), n0 = 8 * (item / mt);
    float acc[1][1][4];
    zero(acc);
    warp_mma3(acc, {View{qs, ldq, 1, P}}, {m0}, 1, View{ks, ldq, 1, P}, n0,
              D);
    store_tile(acc[0], m0, n0, P, P,
               [&](int p, int r, float e) { as[p * lda + r] = e; });
    zero(acc);
    warp_mma3(acc, {View{dys, ldv, 1, P}}, {m0}, 1, View{vs, ldv, 1, P}, n0,
              C);
    store_tile(acc[0], m0, n0, P, P,
               [&](int p, int r, float e) { es[p * lda + r] = e; });
  }
  __syncthreads();

  const float dg_part =
      P <= 5 * kWarps
          ? pam_softmax<5, kNarrowP / 32>(as, es, P, P, lda, g, warp, lane)
          : pam_softmax<kNarrowP / kWarps, kNarrowP / 32>(as, es, P, P, lda, g,
                                                    warp, lane);
  __syncthreads();

  // dv^T = gp dy^T A, [C, P], K = P (masked): 16 channels by all of P
  // per item (P on the n8 axis, as in CAM); dq = dE k and dk = dE^T q,
  // [P, D], K = P (masked): 16 x 8 per item
  const int iv = C / 16, iq = mt * ((D + 7) / 8);
  for (int item = warp; item < iv + 2 * iq; item += kWarps) {
    if (item < iv) {
      const int m0 = 16 * item;
      float acc[1][8][4];
      zero(acc);
      warp_mma3(acc, {View{dys, 1, ldv, C}}, {m0}, 1, View{as, 1, lda, P}, 0,
                P, nt);
      store_tile(acc[0], m0, 0, C, P,
                 [&](int c, int r, float s) { dv[r * C + c] = g * s; });
      continue;
    }
    const int it = (item - iv) % iq;
    const int m0 = 16 * (it % mt), n0 = 8 * (it / mt);
    float acc[1][1][4];
    zero(acc);
    if (item - iv < iq) {
      warp_mma3(acc, {View{es, lda, 1, P}}, {m0}, 1, View{ks, 1, ldq, D}, n0,
                P);
      store_tile(acc[0], m0, n0, P, D,
                 [&](int p, int d, float s) { dq[p * D + d] = s; });
    } else {
      warp_mma3(acc, {View{es, 1, lda, P}}, {m0}, 1, View{qs, 1, ldq, D}, n0,
                P);
      store_tile(acc[0], m0, n0, P, D,
                 [&](int r, int d, float s) { dk[r * D + d] = s; });
    }
  }
  const float total = block_sum(dg_part, red);
  if (threadIdx.x == 0) *dg = total;
}

// ------------------------------------------------------- wide kernel
//
// Shapes past the narrow kernel's (P > 64, C > 128 or D > 32: deep
// backbones' C = 512, D = 64 heads, cameras of more than 5 x 8 features)
// need another split: the narrow CAM rank holds x, two [32, C] matrices
// and an [nc, P, 32] receive buffer (312 KB at C = 512, P = 40), and the
// narrow PAM block two [P, P] matrices beside v and dy (over 1 MB at
// P = 256, C = 512). This kernel keeps every block's shared memory to
// [P, 32] slabs and [32, 32] or [32, P] tiles:
// - CAM: a cluster of S = C / 32 ranks (at most 8; above C = 256 a rank
//   takes two 32-row groups, so that the cluster stays portable), rank r
//   owning groups g = r, r + S, ... of Gram rows and of dx_c columns.
//   Pass 1, per group g and chunk c of 32 columns: G[g, c] = x_g^T x_c and
//   H[g, c] = dy_g^T x_c, folded into each row's running min mu_i (the
//   softmax of rowmax(G) - G is exp(min_j G_ij - G_ij) / S_i), sum
//   S_i = sum_j exp(mu_i - G_ij) and W_i = sum_j H_ij exp(mu_i - G_ij),
//   rescaled as mu falls; then dot_i = gc W_i / S_i and the rank's share
//   of dgc, sum_i W_i / S_i. Each rank stores (mu, 1 / S, dot) of its
//   rows into every rank's shared memory (distributed shared memory:
//   3 C floats a rank, where the narrow kernel sends [P, C]). Pass 2, per
//   group g and chunk c: G[c, g], H[c, g] and H[g, c] again, from them
//   M = gc Bm[c, g] and N = dN[c, g] + dN[g, c]^T with every row's
//   statistics, and dx_c[:, g] = dy_g + sum_c (dy_c M - x_c N) in
//   registers. That is 7 C^2 P multiply-adds a row against the narrow
//   kernel's 5, for no [P, C] exchange.
// - PAM: one block per batch row (no cluster barrier). Pass 1, per chunk
//   of 32 query rows: E = q_Q k^T and G = dy_Q v^T over all keys (v and
//   dy in 128-channel slabs), whole rows, so their softmax and chain rule
//   run as in the narrow block; dq_Q = dE_Q k; A_Q and dE_Q go to a
//   [B, 2, P, P'] f32 scratch the wrapper allocates, transposed (P' = P
//   rounded up to 4). Pass 2, per chunk K of 32 keys: dk_K = dE[:, K]^T q
//   and dv_K = gp A[:, K]^T dy (dy in 32-channel slabs), reading the
//   scratch back. The attention is still recomputed from the inputs, not
//   saved by the forward; the scratch lives for this launch only.
// Shared memory: 167 KB (CAM) and 179 KB (PAM) at P = 256, C = 512,
// D = 64; 43 KB and 64 KB at P = 40. Gamma shares as in the narrow
// kernel, [2, B, S].

__host__ __device__ inline int wide_ranks(int C) {
  const int nc = C / kRows;
  return nc <= kMaxRanks ? nc : (nc + 1) / 2;
}
__host__ __device__ inline int scratch_ld(int P) { return (P + 3) / 4 * 4; }

__host__ __device__ inline size_t cam_wide_floats(int P, int C) {
  return 4 * static_cast<size_t>(P) * ld4(kRows) +
         3 * static_cast<size_t>(kRows) * ld4(kRows) + 3 * static_cast<size_t>(C);
}
__host__ __device__ inline size_t pam_wide_floats(int P, int D) {
  const size_t pass1 = static_cast<size_t>(kRows) * ld4(D) +
                       2 * static_cast<size_t>(kRows) * ld4(kCC) +
                       2 * static_cast<size_t>(kRows) * ld4(P);
  const size_t pass2 = 2 * static_cast<size_t>(kRows) * ld4(P) +
                       static_cast<size_t>(P) * ld4(kRows);
  return static_cast<size_t>(P) * ld4(D) + (pass1 > pass2 ? pass1 : pass2);
}
size_t wide_smem_bytes(int P, int C, int D) {
  const size_t a = cam_wide_floats(P, C), b = pam_wide_floats(P, D);
  return (a > b ? a : b) * sizeof(float);
}

template <int R>
__device__ __forceinline__ void warp_min_n(float (&v)[R]) {
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = fminf(v[r], __shfl_xor_sync(0xffffffffu, v[r], o));
}

// CAM rank r of S of one batch row (see above). x, dy, dx: [P, C].
__device__ void cam_rank_wide(const float* __restrict__ x,
                              const float* __restrict__ dy, float g,
                              float* __restrict__ dx, float* __restrict__ dg,
                              int P, int C, int r, int S, float* sm,
                              float* red) {
  constexpr int ld = ld4(kRows);
  constexpr int kR = kRows / kWarps;          // rows of a warp in pass 1
  const int nc = C / kRows;
  float* xg = sm;                      // [P][ld]: x[:, I_g]
  float* dyg = xg + P * ld;            // [P][ld]: dy[:, I_g]
  float* xc = dyg + P * ld;            // [P][ld]: x[:, I_c]
  float* dyc = xc + P * ld;            // [P][ld]: dy[:, I_c]
  float* t1 = dyc + P * ld;            // [32][ld]: G, then M
  float* t2 = t1 + kRows * ld;         // [32][ld]: H[c, g], then N
  float* t3 = t2 + kRows * ld;         // [32][ld]: H[g, c]
  float* mu = t3 + kRows * ld;         // [C]: row min of G
  float* inv = mu + C;                 // [C]: 1 / S
  float* dot = inv + C;                // [C]: gc W / S
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);   // a 32 x 32 tile
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();                    // this block has started
  float dg_part = 0.0f;
  bool peers_started = false;

  // pass 1: the statistics of the rows of this rank's groups
  for (int grp = r; grp < nc; grp += S) {
    const int g0 = kRows * grp;
    load_rows4(xg, ld, x, P, kRows, C, g0);
    load_rows4(dyg, ld, dy, P, kRows, C, g0);
    float m[kR], s[kR], w[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      m[rr] = INFINITY;
      s[rr] = w[rr] = 0.f;
    }
    for (int c = 0; c < nc; ++c) {
      load_rows4(xc, ld, x, P, kRows, C, kRows * c);
      cp_wait_all();
      __syncthreads();
      float acc[2][1][4];
      zero(acc);
      warp_mma3(acc, {View{xg, 1, ld, kRows}, View{dyg, 1, ld, kRows}},
                {m0, m0}, 2, View{xc, 1, ld, kRows}, n0, P);
      store_tile(acc[0], m0, n0, kRows, kRows,
                 [&](int i, int j, float v) { t1[i * ld + j] = v; });
      store_tile(acc[1], m0, n0, kRows, kRows,
                 [&](int i, int j, float v) { t3[i * ld + j] = v; });
      __syncthreads();
      float gv[kR], hv[kR], cm[kR], es[kR], eh[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int i = warp + kWarps * rr;
        gv[rr] = t1[i * ld + lane];
        hv[rr] = t3[i * ld + lane];
        cm[rr] = gv[rr];
      }
      warp_min_n(cm);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const float nm = fminf(m[rr], cm[rr]);
        const float scale = expf(nm - m[rr]);    // 0 on the first chunk
        es[rr] = expf(nm - gv[rr]);
        eh[rr] = es[rr] * hv[rr];
        s[rr] *= scale;
        w[rr] *= scale;
        m[rr] = nm;
      }
      warp_sum_n(es);
      warp_sum_n(eh);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        s[rr] += es[rr];
        w[rr] += eh[rr];
      }
    }
    if (!peers_started) {
      cluster_wait();                  // every peer has started
      peers_started = true;
    }
    if (lane == 0) {
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int i = g0 + warp + kWarps * rr;
        const float is = 1.f / s[rr];
        dg_part += w[rr] * is;
        for (int q = 0; q < S; ++q) {
          float* to = cluster.map_shared_rank(mu, q);
          to[i] = m[rr];
          to[C + i] = is;
          to[2 * C + i] = g * w[rr] * is;
        }
      }
    }
  }
  if (!peers_started) cluster_wait();
  cluster_arrive();                    // this rank's statistics are sent
  cluster_wait();                      // every rank's have arrived; no rank
                                       // touches another's memory after this

  // pass 2: dx_c[:, I_g] for this rank's groups, P rows in m16 tiles
  // (warp w: tiles w and w + 8) by 32 columns
  const int mtiles = (P + 15) / 16;
  const int mt = (warp < mtiles) + (warp + kWarps < mtiles);
  for (int grp = r; grp < nc; grp += S) {
    const int g0 = kRows * grp;
    if (S < nc) {                      // else x_g and dy_g are still loaded
      __syncthreads();                 // the last group's dx is stored
      load_rows4(xg, ld, x, P, kRows, C, g0);
      load_rows4(dyg, ld, dy, P, kRows, C, g0);
    }
    float acc[2][4][4];
    zero(acc);
    for (int c = 0; c < nc; ++c) {
      const int c0 = kRows * c;
      load_rows4(xc, ld, x, P, kRows, C, c0);
      load_rows4(dyc, ld, dy, P, kRows, C, c0);
      cp_wait_all();
      __syncthreads();
      {
        // t1 = G[c, g] = x_c^T x_g, t2 = H[c, g] = dy_c^T x_g,
        // t3 = H[g, c] = dy_g^T x_c
        float a2[2][1][4], a1[1][1][4];
        zero(a2);
        zero(a1);
        warp_mma3(a2, {View{xc, 1, ld, kRows}, View{dyc, 1, ld, kRows}},
                  {m0, m0}, 2, View{xg, 1, ld, kRows}, n0, P);
        warp_mma3(a1, {View{dyg, 1, ld, kRows}}, {m0}, 1,
                  View{xc, 1, ld, kRows}, n0, P);
        store_tile(a2[0], m0, n0, kRows, kRows,
                   [&](int i, int j, float v) { t1[i * ld + j] = v; });
        store_tile(a2[1], m0, n0, kRows, kRows,
                   [&](int i, int j, float v) { t2[i * ld + j] = v; });
        store_tile(a1[0], m0, n0, kRows, kRows,
                   [&](int i, int j, float v) { t3[i * ld + j] = v; });
      }
      __syncthreads();
      // M[i, j] = gc Bm[c_i, g_j]; N[i, j] = dN[c_i, g_j] + dN[g_j, c_i]
      for (int e = threadIdx.x; e < kRows * kRows; e += kThreads) {
        const int i = e / kRows, j = e % kRows;
        const int ci = c0 + i, gj = g0 + j;
        const float gij = t1[i * ld + j];
        const float bc = expf(mu[ci] - gij) * inv[ci];
        const float bg = expf(mu[gj] - gij) * inv[gj];
        const float ncg = bc * (g * t2[i * ld + j] - dot[ci]);
        const float ngc = bg * (g * t3[j * ld + i] - dot[gj]);
        t1[i * ld + j] = g * bc;
        t2[i * ld + j] = ncg + ngc;
      }
      __syncthreads();
      if (mt > 0) {
        const int ms[2] = {16 * warp, 16 * (warp + kWarps)};
        warp_mma3(acc, {View{dyc, ld, 1, P}, View{dyc, ld, 1, P}}, ms, mt,
                  View{t1, 1, ld, kRows}, 0, kRows);
        warp_mma3<2, 4, true>(acc, {View{xc, ld, 1, P}, View{xc, ld, 1, P}},
                              ms, mt, View{t2, 1, ld, kRows}, 0, kRows);
      }
      __syncthreads();                 // before the next chunk's loads
    }
    for (int i = 0; i < mt; ++i) {
      store_tile(acc[i], 16 * (warp + kWarps * i), 0, P, kRows,
                 [&](int p, int j, float v) {
                   dx[p * C + g0 + j] = dyg[p * ld + j] + v;
                 });
    }
  }
  const float total = block_sum(dg_part, red);
  if (threadIdx.x == 0) *dg = total;
}

// PAM of one batch row (see above); scr: this row's [2][P][P'] scratch.
// q, k, dq, dk: [P, D]; v, dy, dv: [P, C].
__device__ void pam_block_wide(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dy, float g,
                               float* __restrict__ dq, float* __restrict__ dk,
                               float* __restrict__ dv, float* __restrict__ dg,
                               float* __restrict__ scr, int P, int C, int D,
                               float* sm, float* red) {
  constexpr int ldc = ld4(kCC), ld32 = ld4(kRows);
  const int ldq = ld4(D), lde = ld4(P), sp = scratch_ld(P);
  const int nchunks = (P + kRows - 1) / kRows, ntd = (D + 7) / 8;
  float* kq = sm;                      // [P][ldq]: k (pass 1), q (pass 2)
  float* qs = kq + P * ldq;            // pass 1: [32][ldq] q_Q
  float* dys = qs + kRows * ldq;       //         [32][ldc] dy_Q slab
  float* vs = dys + kRows * ldc;       //         [32][ldc] v_K slab
  float* es = vs + kRows * ldc;        //         [32][lde] E, then A
  float* gs = es + kRows * lde;        //         [32][lde] G, then dE
  float* at = kq + P * ldq;            // pass 2: [32][lde] A[:, K]^T
  float* det = at + kRows * lde;       //         [32][lde] dE[:, K]^T
  float* dyc = det + kRows * lde;      //         [P][ld32] dy slab
  float* sa = scr;                     // [P][sp]: A^T
  float* se = scr + static_cast<size_t>(P) * sp;   // [P][sp]: dE^T
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);   // a 32 x 32 tile
  float dg_part = 0.f;
  load_rows(kq, ldq, k, P, D);

  // pass 1, per chunk of query rows
  for (int qc = 0; qc < nchunks; ++qc) {
    const int q0 = kRows * qc, nq = min(kRows, P - q0);
    load_rows(qs, ldq, q + q0 * D, nq, D);
    for (int kc = 0; kc < nchunks; ++kc) {
      const int k0 = kRows * kc, nk = min(kRows, P - k0);
      float ag[1][1][4], ae[1][1][4];
      zero(ag);
      zero(ae);
      for (int c0 = 0; c0 < C; c0 += kCC) {
        const int cw = min(kCC, C - c0);
        load_rows4(dys, ldc, dy + q0 * C, nq, cw, C, c0);
        load_rows4(vs, ldc, v + k0 * C, nk, cw, C, c0);
        cp_wait_all();
        __syncthreads();
        warp_mma3(ag, {View{dys, ldc, 1, nq}}, {m0}, 1,
                  View{vs, ldc, 1, nk}, n0, cw);
        __syncthreads();
      }
      warp_mma3(ae, {View{qs, ldq, 1, nq}}, {m0}, 1,
                View{kq + k0 * ldq, ldq, 1, nk}, n0, D);
      store_tile(ae[0], m0, n0, nq, nk,
                 [&](int i, int j, float e) { es[i * lde + k0 + j] = e; });
      store_tile(ag[0], m0, n0, nq, nk,
                 [&](int i, int j, float e) { gs[i * lde + k0 + j] = e; });
    }
    __syncthreads();
    dg_part += pam_softmax<kRows / kWarps, kMaxP / 32>(es, gs, nq, P, lde, g,
                                                       warp, lane);
    __syncthreads();
    // dq_Q = dE_Q k, [32, D], K = P: items of 16 x 8
    for (int item = warp; item < 2 * ntd; item += kWarps) {
      const int im = 16 * (item & 1), in = 8 * (item >> 1);
      float acc[1][1][4];
      zero(acc);
      warp_mma3(acc, {View{gs, lde, 1, nq}}, {im}, 1, View{kq, 1, ldq, D}, in,
                P);
      store_tile(acc[0], im, in, nq, D,
                 [&](int i, int d, float s) { dq[(q0 + i) * D + d] = s; });
    }
    // A_Q^T and dE_Q^T into the scratch, coalesced along the queries
    for (int e = threadIdx.x; e < nq * P; e += kThreads) {
      const int key = e / nq, i = e % nq;
      sa[key * sp + q0 + i] = es[i * lde + key];
      se[key * sp + q0 + i] = gs[i * lde + key];
    }
    __syncthreads();
  }

  // pass 2, per chunk of keys
  load_rows(kq, ldq, q, P, D);
  for (int kc = 0; kc < nchunks; ++kc) {
    const int k0 = kRows * kc, nk = min(kRows, P - k0);
    load_rows4(at, lde, sa + k0 * sp, nk, sp, sp, 0);
    load_rows4(det, lde, se + k0 * sp, nk, sp, sp, 0);
    cp_wait_all();
    __syncthreads();
    // dk_K = dE[:, K]^T q, [32, D], K = P
    for (int item = warp; item < 2 * ntd; item += kWarps) {
      const int im = 16 * (item & 1), in = 8 * (item >> 1);
      float acc[1][1][4];
      zero(acc);
      warp_mma3(acc, {View{det, lde, 1, nk}}, {im}, 1, View{kq, 1, ldq, D},
                in, P);
      store_tile(acc[0], im, in, nk, D,
                 [&](int i, int d, float s) { dk[(k0 + i) * D + d] = s; });
    }
    // dv_K = gp A[:, K]^T dy, [32, C], K = P, 32 channels at a time
    for (int c0 = 0; c0 < C; c0 += kRows) {
      load_rows4(dyc, ld32, dy, P, kRows, C, c0);
      cp_wait_all();
      __syncthreads();
      float acc[1][1][4];
      zero(acc);
      warp_mma3(acc, {View{at, lde, 1, nk}}, {m0}, 1,
                View{dyc, 1, ld32, kRows}, n0, P);
      store_tile(acc[0], m0, n0, nk, kRows, [&](int i, int c, float s) {
        dv[(k0 + i) * C + c0 + c] = g * s;
      });
      __syncthreads();
    }
  }
  const float total = block_sum(dg_part, red);
  if (threadIdx.x == 0) *dg = total;
}

// ------------------------------------------------------- kernels

// Block (r, y), y < B: CAM rank r (its cluster rank) of batch row y;
// block (x, y), y >= B: the PAM block of batch row (y - B) nc + x, if
// there is one. dgamma: [2, B, nc]; [0, b, 0] the PAM block's share,
// [0, b, 1 ..] zeros, [1, b, r] CAM rank r's.
__global__ void __launch_bounds__(kThreads, 2)
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
  const int nc = C / kRows;
  const bool cam = blockIdx.y < B;
  const int rank = blockIdx.x;
  const int b = cam ? blockIdx.y : (blockIdx.y - B) * nc + blockIdx.x;
  if (b >= B) return;                  // past the last PAM block
  const size_t ov = static_cast<size_t>(b) * P * C;
  const size_t oq = static_cast<size_t>(b) * P * D;
  float* share = dgamma + static_cast<size_t>(b) * nc;
  if (cam) {
    cam_rank(xc + ov, dyc + ov, gc[0], dxc + ov,
             share + static_cast<size_t>(B) * nc + rank, P, C, rank, nc, sm,
             red);
  } else {
    if (threadIdx.x > 0 && threadIdx.x < nc) share[threadIdx.x] = 0.f;
    pam_block(q + oq, k + oq, v + ov, dyp + ov, gp[0], dq + oq,
              dk + oq, dv + ov, share, P, C, D, sm, red);
  }
}

// The same grid and share layout with S = wide_ranks(C) blocks to a
// cluster; scratch: [B, 2, P, scratch_ld(P)] f32 for the PAM blocks. Two
// blocks an SM (128 registers, a few bytes of spills): at one (178
// registers) only 15 clusters of 8 were active at once, and B = 48,
// C = 512 took 0.795 ms against 0.535 (H100 80GB HBM3, 700 W).
__global__ void __launch_bounds__(kThreads, 2)
dual_attention_bwd_wide_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ gp,
                               const float* __restrict__ xc,
                               const float* __restrict__ gc,
                               const float* __restrict__ dyp,
                               const float* __restrict__ dyc,
                               float* __restrict__ dq, float* __restrict__ dk,
                               float* __restrict__ dv, float* __restrict__ dxc,
                               float* __restrict__ dgamma,
                               float* __restrict__ scratch, int B, int P,
                               int C, int D) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  const int S = wide_ranks(C);
  const bool cam = blockIdx.y < B;
  const int rank = blockIdx.x;
  const int b = cam ? blockIdx.y : (blockIdx.y - B) * S + blockIdx.x;
  if (b >= B) return;                  // past the last PAM block
  const size_t ov = static_cast<size_t>(b) * P * C;
  const size_t oq = static_cast<size_t>(b) * P * D;
  float* share = dgamma + static_cast<size_t>(b) * S;
  if (cam) {
    cam_rank_wide(xc + ov, dyc + ov, gc[0], dxc + ov,
                  share + static_cast<size_t>(B) * S + rank, P, C, rank, S,
                  sm, red);
  } else {
    if (threadIdx.x > 0 && threadIdx.x < S) share[threadIdx.x] = 0.f;
    pam_block_wide(q + oq, k + oq, v + ov, dyp + ov, gp[0], dq + oq, dk + oq,
                   dv + ov, share,
                   scratch + static_cast<size_t>(b) * 2 * P * scratch_ld(P),
                   P, C, D, sm, red);
  }
}

bool narrow(int P, int C, int D) {
  return P <= kNarrowP && C <= kNarrowC && D <= kNarrowD;
}

bool takes(int P, int C, int D) {
  return P >= 1 && P <= kMaxP && C >= kRows && C <= kMaxC && C % kRows == 0 &&
         D >= 1 && D <= kMaxD;
}

int cluster_size(int P, int C, int D) {
  return narrow(P, C, D) ? C / kRows : wide_ranks(C);
}

// Opts both kernels in to the dynamic shared memory of the largest shape
// each takes and to the largest shared-memory carveout, once per device
// (the attributes are the device's, so later launches there skip the host
// calls).
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      dual_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kNarrowP, kNarrowC, kNarrowD)));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dual_attention_bwd_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        dual_attention_bwd_wide_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(wide_smem_bytes(kMaxP, kMaxC, kMaxD)));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dual_attention_bwd_wide_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The launch of B batch rows: a grid of (S, B + ceil(B / S)) blocks in
// clusters of (S, 1, 1), S = cluster_size(P, C, D).
void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B,
               int P, int C, int D, cudaStream_t stream) {
  const int size = cluster_size(P, C, D);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(size, B + (B + size - 1) / size, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes =
      narrow(P, C, D) ? smem_bytes(P, C, D) : wide_smem_bytes(P, C, D);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

// q, k, dq, dk: [B, P, D]; v, x_cam, dy_pam, dy_cam, dv, dx_cam: [B, P, C];
// gamma_pam, gamma_cam: [1]; all f32, contiguous, on the device; v, x_cam,
// dy_pam, dy_cam and dx_cam 16-byte aligned. dgamma: [2, B * S] f32,
// S = dual_attention_bwd_cluster_size(P, C, D); row 0 gets each batch
// row's share of dgamma_pam (then S - 1 zeros), row 1 each CAM rank's
// share of dgamma_cam, so that one sum over the last axis gives both.
// scratch: [B, 2, P, (P + 3) / 4 * 4] f32, read only by the wide kernel
// (P > 64, C > 128 or D > 32). 1 <= P <= 256, C a multiple of 32 up to
// 512, 1 <= D <= 64 (the wrapper checks). Returns cudaGetLastError() (or
// the error of the shared-memory opt-in or of the launch).
extern "C" int dual_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* gamma_pam,
    const void* x_cam, const void* gamma_cam, const void* dy_pam,
    const void* dy_cam, void* dq, void* dk, void* dv, void* dx_cam,
    void* dgamma, void* scratch, int B, int P, int C, int D, void* stream) {
  if (!takes(P, C, D) || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, B, P, C, D, static_cast<cudaStream_t>(stream));
  const float* args[8] = {
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(gamma_pam),
      static_cast<const float*>(x_cam), static_cast<const float*>(gamma_cam),
      static_cast<const float*>(dy_pam), static_cast<const float*>(dy_cam)};
  if (narrow(P, C, D)) {
    err = cudaLaunchKernelEx(
        &cfg, dual_attention_bwd_kernel, args[0], args[1], args[2], args[3],
        args[4], args[5], args[6], args[7], static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(dx_cam), static_cast<float*>(dgamma), B, P, C, D);
  } else {
    err = cudaLaunchKernelEx(
        &cfg, dual_attention_bwd_wide_kernel, args[0], args[1], args[2],
        args[3], args[4], args[5], args[6], args[7], static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(dx_cam), static_cast<float*>(dgamma),
        static_cast<float*>(scratch), B, P, C, D);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one block uses, which chip_smoke.py
// reports beside the kernel's times; -1 for a shape it does not take.
extern "C" long long dual_attention_bwd_smem_bytes(int P, int C, int D) {
  if (!takes(P, C, D)) return -1;
  return static_cast<long long>(narrow(P, C, D) ? smem_bytes(P, C, D)
                                                : wide_smem_bytes(P, C, D));
}

// Blocks in one cluster (S); -1 for a shape the kernel does not take.
extern "C" int dual_attention_bwd_cluster_size(int P, int C, int D) {
  return takes(P, C, D) ? cluster_size(P, C, D) : -1;
}

// How many of a shape's clusters the device can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int dual_attention_bwd_active_clusters(int P, int C, int D) {
  if (!takes(P, C, D)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, 1, P, C, D, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n,
      narrow(P, C, D)
          ? reinterpret_cast<const void*>(dual_attention_bwd_kernel)
          : reinterpret_cast<const void*>(dual_attention_bwd_wide_kernel),
      &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
