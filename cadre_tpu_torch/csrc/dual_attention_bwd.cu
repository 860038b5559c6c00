// Backward of the fused position (PAM) and channel (CAM) attention of the
// DANet head, f32: per batch row, thread-block clusters of CAM blocks and
// of PAM blocks, every product on the tensor cores in 3xTF32. Two kernels:
// the first (below) for P <= 64, C <= 128, D <= 32, the main path's heads
// (resnet18/34 at 144x256); the wide one ("wide kernel" below) for the
// rest of the domain the wrapper takes: any P, C <= 512, D <= 64.
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
// of bytes at 3.35 TB/s. At C = 512 the CAM products are 16x those for 4x
// the bytes, and on a large camera the PAM products grow as P^2: both are
// bound by operations. In practice each block is bound by the latency of
// its chain of phases, which the designs below shorten.
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
// - Products: mma.sync.m16n8k8 in 3xTF32 (mma_tf32.cuh, which says why
//   plain TF32 is not enough); the [*, P] products (x dN_r^T, dv) run
//   transposed, P on the n8 axis, where P = 40 is five tiles without
//   padding. wgmma is not used: these products are 32- to 64-row slabs
//   with K of 32-128, below its 64-row warpgroup tile.
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

#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

using mma3::ld4;
using mma3::ld8;
using mma3::store_tile;
using mma3::View;
using mma3::warp_mma3;
using mma3::zero;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;        // Gram rows of one CAM rank
constexpr int kNarrowC = 128;    // what the narrow kernel takes
constexpr int kNarrowP = 64;
constexpr int kNarrowD = 32;
constexpr int kMaxC = 512;       // what the wide kernel takes (the wrapper's
constexpr int kMaxD = 64;        // limits; any P)
constexpr int kMaxRanks = 8;     // a portable cluster

__device__ __forceinline__ void cp_wait_all() {
  mma3::cp_commit();
  mma3::cp_wait<0>();
}
__device__ __forceinline__ void load_rows4(float* dst, int ld,
                                           const float* __restrict__ src,
                                           int rows, int cols, int C, int c0) {
  mma3::load_rows16(dst, ld, src, rows, cols, C, c0, kThreads);
}
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int rows, int cols) {
  mma3::load_rows(dst, ld, src, rows, cols, kThreads);
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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
// backbones' C = 512, D = 64 heads, cameras of more than 5 x 8 features
// up to CARLA's 800x600 and past it) need another split: the narrow CAM
// rank holds x, two [32, C] matrices and an [nc, P, 32] receive buffer
// (312 KB at C = 512, P = 40), and the narrow PAM block two [P, P]
// matrices beside v and dy. In this kernel no block's shared memory or
// registers grow with P: positions, queries and keys all come in tiles
// (16 or 32 positions), two tiles in flight (cp.async brings in the next
// while the current one is multiplied, one barrier a tile). Per batch row
// a cluster of S CAM ranks, S = C / 32 up to 8 (above C = 256 a rank
// takes two 32-row groups, so that the cluster stays portable), and Sp
// PAM ranks (Sp the largest divisor of S up to the number of query
// tiles), S / Sp batch rows' PAM ranks to a cluster:
// - CAM rank r owns groups g = r, r + S, ... of Gram rows and of dx_c
//   columns. Pass 1, per group: G[g, :] = x_g^T x and H[g, :] = dy_g^T x
//   summed over the position tiles, in chunks of 128 columns (256 above
//   C = 256), into the group's [32, C] G and H rows in shared memory; then
//   each row's min mu_i (the softmax of rowmax(G) - G is exp(mu_i - G_ij)
//   / S_i), S_i = sum_j exp(mu_i - G_ij) and W_i = sum_j H_ij
//   exp(mu_i - G_ij), dot_i = gc W_i / S_i and the rank's share of dgc,
//   sum_i W_i / S_i. Each rank stores (mu, 1 / S, dot) of its rows into
//   every rank's shared memory (distributed shared memory: 3 C floats a
//   rank). Pass 2, per group, the last first (its G and H are still in
//   shared memory; a rank's other group computes them again): H[c, g]^T =
//   x_g^T dy_c over the position tiles, and from it, G and H and every
//   row's statistics, M = gc Bm[c, g] and N = dN[c, g] + dN[g, c]^T over
//   G and H in place (as M^T and N^T); then per position tile and chunk
//   of 128 channels, dx_c[p, g] = dy[p, g] + sum_c (dy[p, c] M[c, g] -
//   x[p, c] N[c, g]), each warp a 16-channel slice of the chunk over the
//   whole tile (eight independent sums, where one m16n8 tile a warp over
//   all of C was a serial chain), the warps' sums added in warp order.
//   That is 5 C^2 P multiply-adds a row (7 for a rank's first group
//   above C = 256), as the narrow kernel's, for no [P, C] exchange.
// - PAM rank r of a row takes query tiles Q = r, r + Sp, ... in phase 1,
//   then key tiles K = Sp - 1 - r, 2 Sp - 1 - r, ... in phase 2 (so that
//   a rank with one query tile more has one key tile less), the two
//   phases split by
//   a cluster barrier; A and dE go between them through a [B, 2, P, P']
//   f32 scratch the wrapper allocates (P' = P rounded up to 4; 1.81 MB a
//   row at P = 475). Phase 1, per query tile: over the key tiles, E = q_Q
//   k_K^T and G = dy_Q v_K^T (dy and v in slabs of 128 channels), each
//   row's running max m, sum l of exp(E - m) and sum of exp(E - m) G
//   (whose quotient by l is D_i = sum_j A_ij G_ij, the flash-attention
//   identity rowsum(dA * A)_i = gp D_i), E and G stored to the scratch;
//   then over the key tiles again, A = exp(E - m) / l and dE = A (gp G -
//   gp D_i) from the scratch (each thread reads back what it wrote), A
//   and dE stored over E and G, and dq_Q += dE_QK k_K. Phase 2, per key
//   tile: dk_K = sum_Q dE_QK^T q_Q and dv_K = gp sum_Q A_QK^T dy_Q (dy in
//   slabs of 128 channels), read back from the scratch after the cluster
//   barrier. The attention is still recomputed from the inputs, not
//   saved by the forward; the scratch lives for this launch only.
// Shared memory: 103 KB up to C = 256 (two blocks an SM), 226 KB at
// C = 512 (one), whatever P. Gamma shares [2, B, S], one per rank.
// Measured (H100 80GB HBM3, 700 W, B = 48, graphs of 200 calls): 0.556
// ms at C = 512, P = 40, where the CAM clusters alone take 0.546 (one
// block an SM, the 3xTF32 products at about a sixth of mma.sync's rate:
// per-warp chains of small tiles); 0.178 ms at C = 128, P = 144, where
// the PAM clusters alone take 0.121 (five query and five key tiles over
// four ranks, the phases split by a barrier). The earlier wide kernel
// took 0.540 and 0.174 on the same card, but refused P > 256.

constexpr int kTP = 32;          // queries or keys of a PAM tile
constexpr int kKC = 128;         // channels of a dx_c chunk (CAM)
constexpr int kCS = 128;         // channels of a dy and v slab (PAM)

__host__ __device__ inline int wide_ranks(int C) {
  const int nc = C / kRows;
  return nc <= kMaxRanks ? nc : (nc + 1) / 2;
}
// PAM ranks of a batch row: the largest divisor of S up to the number of
// query tiles
__host__ __device__ inline int pam_ranks(int P, int C) {
  const int S = wide_ranks(C), nt = (P + kTP - 1) / kTP;
  int sp = S;
  while (sp > 1 && (S % sp || sp > nt)) --sp;
  return sp;
}
__host__ __device__ inline int scratch_ld(int P) { return (P + 3) / 4 * 4; }
// A CAM rank's chunk of Gram columns (128, 256 above C = 256: the
// accumulators of G and H, 64 registers a thread at most) and position
// tile (32, 16 at 128 < C <= 256: two blocks an SM)
__host__ __device__ inline int cam_cw(int C) { return C > 256 ? 256 : 128; }
__host__ __device__ inline int cam_tp(int C) {
  return C > 128 && C <= 256 ? 16 : 32;
}

// A CAM rank: its rows' statistics (3 C), its group's G and H ([32, C]
// each; later M^T and N^T) and two tile buffers, each a [tp, cw] chunk
// of x or dy and [tp, 32] slabs x_g and dy_g, or [tp, 128] chunks of dy
// and x, then the warps' [tp, 32] sums of dx_c.
__host__ __device__ inline int cam_buf(int C) {
  const int tp = cam_tp(C);
  const int a = tp * (ld8(cam_cw(C)) + 2 * ld8(kRows));
  const int b = 2 * tp * ld4(kKC);
  const int c = kWarps * tp * (kRows + 1);   // the warps' dx_c sums
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
__host__ __device__ inline size_t cam_wide_floats(int C) {
  return 3 * static_cast<size_t>(C) + 2 * static_cast<size_t>(kRows) * ld4(C) +
         2 * static_cast<size_t>(cam_buf(C));
}
// A PAM rank: phase 1's q tile, two buffers (a [32, D] k tile and
// [32, 128] slabs of dy and v) and E and G tiles; phase 2's two buffers
// ([32, 32] tiles of A and dE, a [32, D] q tile, a [32, 128] slab of dy).
__host__ __device__ inline int pam_p1_buf(int C, int D) {
  const int cs = C < kCS ? C : kCS;
  return kTP * (ld4(D) + 2 * ld4(cs));
}
__host__ __device__ inline int pam_p2_buf(int D) {
  return kTP * (2 * ld8(kTP) + ld8(D) + ld8(kCS));
}
__host__ __device__ inline size_t pam_wide_floats(int C, int D) {
  const size_t p1 = kTP * ld4(D) + 2 * pam_p1_buf(C, D) + 2 * kTP * ld4(kTP);
  const size_t p2 = 2 * static_cast<size_t>(pam_p2_buf(D));
  return p1 > p2 ? p1 : p2;
}
size_t wide_smem_bytes(int C, int D) {
  const size_t a = cam_wide_floats(C), b = pam_wide_floats(C, D);
  return (a > b ? a : b) * sizeof(float);
}

template <int R>
__device__ __forceinline__ void warp_min_n(float (&v)[R]) {
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = fminf(v[r], __shfl_xor_sync(0xffffffffu, v[r], o));
}

// CAM rank r of S of one batch row (see above), kCW the chunk of Gram
// columns (cam_cw(C)). x, dy, dx: [P, C].
template <int kCW>
__device__ void cam_rank_wide(const float* __restrict__ x,
                              const float* __restrict__ dy, float g,
                              float* __restrict__ dx, float* __restrict__ dg,
                              int P, int C, int r, int S, float* sm,
                              float* red) {
  constexpr int kNT = kCW / 32;               // n-tiles of a warp's span
  constexpr int ldg = ld8(kRows);             // x_g, dy_g slabs
  constexpr int ldc = ld8(kCW);               // chunks of x or dy
  constexpr int ldk = ld4(kKC);               // dx_c's chunks of dy and x
  constexpr int kR = kRows / kWarps;          // rows of a warp (statistics)
  const int nc = C / kRows, ldm = ld4(C), tp = cam_tp(C);
  const int ntp = (P + tp - 1) / tp, ng = (nc - r + S - 1) / S;
  const int nch = (C + kCW - 1) / kCW, nkc = (C + kKC - 1) / kKC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 1), n0 = (kCW / 4) * (warp >> 1);
  float* mu = sm;                      // [C]: row min of G
  float* inv = mu + C;                 // [C]: 1 / S
  float* dot = inv + C;                // [C]: gc W / S
  float* gs = dot + C;                 // [32][ldm]: G, then M^T
  float* hs = gs + kRows * ldm;        // [32][ldm]: H, then N^T
  float* bufs[2] = {hs + kRows * ldm, hs + kRows * ldm + cam_buf(C)};
  auto rows = [&](int pt) { return min(tp, P - pt * tp); };
  auto group = [&](int gi) { return kRows * (r + S * gi); };
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();                    // this block has started
  float dg_part = 0.0f;

  // the items of the two passes: G and H of a chunk and position tile
  // (kind 0), H[c, g]^T of one (kind 1), dx_c of a position tile and
  // chunk of channels (kind 2)
  struct Item {
    int kind, gi, chunk, pt;
  };
  const int per1 = nch * ntp, n1 = ng * per1;
  auto item1 = [&](int it) { return Item{0, it / per1, it % per1 / ntp, it % ntp}; };
  // pass 2, groups last first: (G and H again unless the last), H^T, dx
  const int per2 = 2 * per1 + ntp * nkc, n2 = ng * per2 - per1;
  auto item2 = [&](int it) {
    it += per1;                        // the last group needs no G and H
    const int gi = ng - 1 - it / per2, e = it % per2;
    if (e < per1) return Item{0, gi, e / ntp, e % ntp};
    if (e < 2 * per1) return Item{1, gi, (e - per1) / ntp, (e - per1) % ntp};
    return Item{2, gi, (e - 2 * per1) % nkc, (e - 2 * per1) / nkc};
  };
  auto issue = [&](const Item& t, int slot) {
    float* b = bufs[slot];
    const int g0 = group(t.gi), np = rows(t.pt);
    const float* xs = x + static_cast<size_t>(t.pt) * tp * C;
    const float* ds = dy + static_cast<size_t>(t.pt) * tp * C;
    if (t.kind < 2) {
      const int c0 = kCW * t.chunk, cw = min(kCW, C - c0);
      load_rows4(b, ldc, t.kind == 0 ? xs : ds, np, cw, C, c0);
      load_rows4(b + tp * ldc, ldg, xs, np, kRows, C, g0);
      if (t.kind == 0) load_rows4(b + tp * ldc + tp * ldg, ldg, ds, np, kRows, C, g0);
    } else {
      const int k0 = kKC * t.chunk, kw = min(kKC, C - k0);
      load_rows4(b, ldk, ds, np, kw, C, k0);
      load_rows4(b + tp * ldk, ldk, xs, np, kw, C, k0);
    }
    mma3::cp_commit();
  };
  // G and H (kind 0), H^T (kind 1), or n-tiles 0-3 a warp's K slice of
  // dx_c (kind 2): the kinds never hold sums at once
  float acc[2][kNT][4];
  zero(acc);
  // one item's products; at the end of a chunk the group's G and H rows
  // (kind 0) or M^T and N^T (kind 1) are stored, at the end of a position
  // tile its dx_c (kind 2)
  auto run = [&](const Item& t, const float* b) {
    const int g0 = group(t.gi), np = rows(t.pt);
    const int gq = lane >> 2, t2 = 2 * (lane & 3);
    if (t.kind == 0) {
      // G and H: a warp's m-tile m0 of both, kNT n-tiles from n0
      const int c0 = kCW * t.chunk, cw = min(kCW, C - c0);
      const int nt = min(kNT, max(0, (cw - n0) / 8));
      if (nt > 0) {
        warp_mma3(acc, {View{b + tp * ldc, 1, ldg, kRows},
                        View{b + tp * ldc + tp * ldg, 1, ldg, kRows}},
                  {m0, m0}, 2, View{b, 1, ldc, cw}, n0, np, nt);
      }
      if (t.pt < ntp - 1) return;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = m0 + gq + 8 * (q >> 1);
          const int o = i * ldm + c0 + n0 + 8 * j + t2 + (q & 1);
          gs[o] = acc[0][j][q];
          hs[o] = acc[1][j][q];
        }
      }
      zero(acc);
      return;
    }
    if (t.kind == 1) {
      // H[c, g]^T = x_g^T dy_c: a warp's kNT / 2 n-tiles from nh of both
      // m-tiles (each dy_c fragment feeds two tiles)
      constexpr int kNH = kNT / 2;
      const int c0 = kCW * t.chunk, cw = min(kCW, C - c0);
      const int nh = (kCW / 8) * warp, nt = min(kNH, max(0, (cw - nh) / 8));
      const View xg{b + tp * ldc, 1, ldg, kRows};
      if (nt > 0) {
        warp_mma3(acc, {xg, xg}, {0, 16}, 2, View{b, 1, ldc, cw}, nh, np, nt);
      }
      if (t.pt < ntp - 1) return;
      // M^T[i, c] = gc Bm[c, g_i]; N^T[i, c] = dN[c, g_i] + dN[g_i, c]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < kNH; ++j) {
          if (j >= nt) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 16 * mi + gq + 8 * (q >> 1), gi = g0 + i;
            const int c = c0 + nh + 8 * j + t2 + (q & 1), o = i * ldm + c;
            const float gv = gs[o];
            const float bc = expf(mu[c] - gv) * inv[c];
            const float bg = expf(mu[gi] - gv) * inv[gi];
            gs[o] = g * bc;
            hs[o] = bc * (g * acc[mi][j][q] - dot[c]) +
                    bg * (g * hs[o] - dot[gi]);
          }
        }
      zero(acc);
      return;
    }
    // dx_c[p, g] += dy[p, c] M[c, g] - x[p, c] N[c, g] over a chunk of
    // kKC channels c: warp w takes channels 16 w .. 16 w + 15 of the chunk
    // for the whole [tp, 32] block (eight m16n8 tiles, eight independent
    // sums where one tile a warp over all of K was a serial chain), and
    // the warps' sums are added in warp order at the position tile's end
    const int k0 = kKC * t.chunk, kw = min(kKC, C - k0);
    const int ks = 16 * warp, kn = min(16, kw - ks);
    if (kn > 0) {
      const int mt = (np + 15) / 16;
      warp_mma3(acc, {View{b + ks, ldk, 1, np}, View{b + ks, ldk, 1, np}},
                {0, 16}, mt, View{gs + k0 + ks, ldm, 1, kRows}, 0, kn, 4);
      warp_mma3<2, kNT, true>(
          acc, {View{b + tp * ldk + ks, ldk, 1, np},
                View{b + tp * ldk + ks, ldk, 1, np}},
          {0, 16}, mt, View{hs + k0 + ks, ldm, 1, kRows}, 0, kn, 4);
    }
    if (t.chunk < nkc - 1) return;
    constexpr int ldr = kRows + 1;
    float* part = const_cast<float*>(b);  // [kWarps][tp][ldr], b is read
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      store_tile(acc[i], 16 * i, 0, np, kRows, [&](int p, int j, float v) {
        part[(warp * tp + p) * ldr + j] = v;
      });
    }
    zero(acc);
    __syncthreads();
    const size_t o = static_cast<size_t>(t.pt) * tp * C + g0;
    for (int e = threadIdx.x; e < np * kRows; e += kThreads) {
      const int p = e / kRows, j = e % kRows;
      float v = part[p * ldr + j];
      for (int w = 1; w < kWarps; ++w) v += part[(w * tp + p) * ldr + j];
      const size_t at = o + static_cast<size_t>(p) * C + j;
      dx[at] = dy[at] + v;
    }
  };

  // pass 1: G and H of each group, then its rows' statistics
  if (n1 > 0) issue(item1(0), 0);
  for (int it = 0; it < n1; ++it) {
    mma3::cp_wait<0>();
    __syncthreads();                   // item it is in; it - 1 is done
    if (it + 1 < n1) issue(item1(it + 1), (it + 1) & 1);
    const Item t = item1(it);
    run(t, bufs[it & 1]);
    if (it % per1 < per1 - 1) continue;
    __syncthreads();                   // the group's G and H are whole
    const int g0 = group(t.gi);
    float m[kR], s[kR], w[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const float* grow = gs + (warp + kWarps * rr) * ldm;
      m[rr] = INFINITY;
      for (int j = lane; j < C; j += 32) m[rr] = fminf(m[rr], grow[j]);
    }
    warp_min_n(m);
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int i = warp + kWarps * rr;
      s[rr] = w[rr] = 0.f;
      for (int j = lane; j < C; j += 32) {
        const float e = expf(m[rr] - gs[i * ldm + j]);
        s[rr] += e;
        w[rr] = fmaf(e, hs[i * ldm + j], w[rr]);
      }
    }
    warp_sum_n(s);
    warp_sum_n(w);
    if (t.gi == 0) cluster_wait();     // every peer has started
    // lane q < S stores the warp's rows into rank q
    float* to = cluster.map_shared_rank(mu, lane < S ? lane : 0);
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int i = g0 + warp + kWarps * rr;
      const float is = 1.f / s[rr];
      if (lane == 0) dg_part += w[rr] * is;
      if (lane < S) {
        to[i] = m[rr];
        to[C + i] = is;
        to[2 * C + i] = g * w[rr] * is;
      }
    }
  }
  cluster_arrive();                    // this rank's statistics are sent
  cluster_wait();                      // every rank's have arrived; no rank
                                       // touches another's memory after this

  // pass 2: dx_c[:, I_g] for this rank's groups
  if (n2 > 0) issue(item2(0), 0);
  for (int it = 0; it < n2; ++it) {
    mma3::cp_wait<0>();
    __syncthreads();                   // item it is in; it - 1 is done
    if (it + 1 < n2) issue(item2(it + 1), (it + 1) & 1);
    run(item2(it), bufs[it & 1]);
  }
  const float total = block_sum(dg_part, red);
  if (threadIdx.x == 0) *dg = total;
}

// PAM rank r of the S ranks of one batch row (see above); scr: this
// row's [2][P][P'] scratch. q, k, dq, dk: [P, D]; v, dy, dv: [P, C]. A
// rank of a row past the last (valid false) only takes part in the
// cluster barrier.
__device__ void pam_rank_wide(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dy, float g,
                              float* __restrict__ dq, float* __restrict__ dk,
                              float* __restrict__ dv, float* __restrict__ dg,
                              float* __restrict__ scr, int P, int C, int D,
                              int r, int S, bool valid, float* sm,
                              float* red) {
  constexpr int ldt = ld4(kTP);        // E, G and dE tiles
  constexpr int ld2 = ld8(kTP);        // phase 2's A and dE tiles
  constexpr int ldy = ld8(kCS);        // phase 2's dy slab
  constexpr int kR = kTP / kWarps;     // rows of a warp (statistics)
  const int ldq = ld4(D), ldq8 = ld8(D), cs = min(C, kCS), lds = ld4(cs);
  const int sp = scratch_ld(P), nt = (P + kTP - 1) / kTP;
  const int nsl = (C + cs - 1) / cs, nsl2 = (C + kCS - 1) / kCS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);
  float* sa = scr;                     // [P][sp]: E, then A
  float* sb = scr + static_cast<size_t>(P) * sp;   // [P][sp]: G, then dE
  auto tile = [&](int t) { return min(kTP, P - t * kTP); };
  float dg_part = 0.f;

  // phase 1, per query tile of this rank
  float* qs = sm;                      // [32][ldq]
  float* b1[2] = {qs + kTP * ldq, qs + kTP * ldq + pam_p1_buf(C, D)};
  float* te = qs + kTP * ldq + 2 * pam_p1_buf(C, D);   // [32][ldt]
  float* tg = te + kTP * ldt;          // [32][ldt]
  for (int qt = valid ? r : nt; qt < nt; qt += S) {
    const int q0 = kTP * qt, nq = tile(qt);
    // (a) items (key tile, slab of dy and v)
    const int n = nt * nsl;
    auto issue = [&](int it) {
      const int kt = it / nsl, c0 = cs * (it % nsl), nk = tile(kt);
      float* kb = b1[it & 1];
      if (it == 0) load_rows(qs, ldq, q + static_cast<size_t>(q0) * D, nq, D);
      if (it % nsl == 0) {
        load_rows(kb, ldq, k + static_cast<size_t>(kt) * kTP * D, nk, D);
      }
      load_rows4(kb + kTP * ldq, lds, dy + static_cast<size_t>(q0) * C, nq,
                 min(cs, C - c0), C, c0);
      load_rows4(kb + kTP * ldq + kTP * lds, lds,
                 v + static_cast<size_t>(kt) * kTP * C, nk, min(cs, C - c0),
                 C, c0);
      mma3::cp_commit();
    };
    float ae[1][1][4], ag[1][1][4];
    zero(ae);
    zero(ag);
    float m[kR], l[kR], ds[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      m[rr] = -INFINITY;
      l[rr] = ds[rr] = 0.f;
    }
    issue(0);
    for (int it = 0; it < n; ++it) {
      mma3::cp_wait<0>();
      __syncthreads();                 // item it is in; it - 1 is done
      if (it + 1 < n) issue(it + 1);
      const int kt = it / nsl, sl = it % nsl, k0 = kTP * kt, nk = tile(kt);
      const float* kb = b1[it & 1];
      if (sl == 0) {
        warp_mma3(ae, {View{qs, ldq, 1, nq}}, {m0}, 1, View{kb, ldq, 1, nk},
                  n0, D);
      }
      warp_mma3(ag, {View{kb + kTP * ldq, lds, 1, nq}}, {m0}, 1,
                View{kb + kTP * ldq + kTP * lds, lds, 1, nk}, n0,
                min(cs, C - cs * sl));
      if (sl < nsl - 1) continue;
      // the key tile's E and G are whole: the running statistics of each
      // row (warp + 8 rr, its keys on the lanes), E and G to the scratch
      store_tile(ae[0], m0, n0, kTP, kTP,
                 [&](int i, int j, float e) { te[i * ldt + j] = e; });
      store_tile(ag[0], m0, n0, kTP, kTP,
                 [&](int i, int j, float e) { tg[i * ldt + j] = e; });
      zero(ae);
      zero(ag);
      __syncthreads();
      float cm[kR], e[kR], gv[kR], ps[kR], pg[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int i = warp + kWarps * rr;
        e[rr] = te[i * ldt + lane];
        gv[rr] = tg[i * ldt + lane];
        if (i < nq && lane < nk) {
          const size_t o = static_cast<size_t>(q0 + i) * sp + k0 + lane;
          __stcg(sa + o, e[rr]);
          __stcg(sb + o, gv[rr]);
        }
        cm[rr] = i >= nq ? 0.f : lane < nk ? e[rr] : -INFINITY;
      }
      warp_max_n(cm);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const float nm = fmaxf(m[rr], cm[rr]);
        const float scale = expf(m[rr] - nm);    // 0 on the first tile
        const float p = lane < nk ? expf(e[rr] - nm) : 0.f;
        ps[rr] = p;
        pg[rr] = p * gv[rr];
        l[rr] *= scale;
        ds[rr] *= scale;
        m[rr] = nm;
      }
      warp_sum_n(ps);
      warp_sum_n(pg);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        l[rr] += ps[rr];
        ds[rr] += pg[rr];
      }
    }
    // D_i = sum_j A_ij G_ij; this rank's share of dgp is their sum
    float dd[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      dd[rr] = ds[rr] / l[rr];
      if (lane == 0 && warp + kWarps * rr < nq) dg_part += dd[rr];
    }

    // (b) per key tile: A and dE over E and G in the scratch, dq_Q +=
    // dE_QK k_K; k a tile ahead, E and G a tile ahead in registers
    float* kbuf[2] = {b1[0], b1[0] + kTP * ldq8};
    float* tde = b1[0] + 2 * kTP * ldq8;   // [32][ldt]
    auto issue_k = [&](int kt) {
      load_rows(kbuf[kt & 1], ldq8, k + static_cast<size_t>(kt) * kTP * D,
                tile(kt), D);
      mma3::cp_commit();
    };
    float en[kR], gn[kR];
    auto fetch = [&](int kt) {
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int i = warp + kWarps * rr;
        if (i < nq && lane < tile(kt)) {
          const size_t o = static_cast<size_t>(q0 + i) * sp + kTP * kt + lane;
          en[rr] = __ldcg(sa + o);
          gn[rr] = __ldcg(sb + o);
        }
      }
    };
    float ad[1][2][4];
    zero(ad);
    const int nd0 = 16 * (warp >> 1), ntd = min(2, max(0, (D - nd0 + 7) / 8));
    issue_k(0);
    fetch(0);
    for (int kt = 0; kt < nt; ++kt) {
      const int nk = tile(kt);
      mma3::cp_wait<0>();
      __syncthreads();                 // k tile kt is in; kt - 1 is done
      float e[kR], gv[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        e[rr] = en[rr];
        gv[rr] = gn[rr];
      }
      if (kt + 1 < nt) {
        issue_k(kt + 1);
        fetch(kt + 1);
      }
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int i = warp + kWarps * rr;
        float de = 0.f;
        if (i < nq && lane < nk) {
          const float a = expf(e[rr] - m[rr]) / l[rr];
          de = a * (g * gv[rr] - g * dd[rr]);
          const size_t o = static_cast<size_t>(q0 + i) * sp + kTP * kt + lane;
          __stcg(sa + o, a);
          __stcg(sb + o, de);
        }
        tde[i * ldt + lane] = de;
      }
      __syncthreads();
      if (ntd > 0) {
        warp_mma3(ad, {View{tde, ldt, 1, nq}}, {m0}, 1,
                  View{kbuf[kt & 1], 1, ldq8, D}, nd0, nk, ntd);
      }
    }
    store_tile(ad[0], m0, nd0, nq, min(D, nd0 + 16), [&](int i, int d, float s) {
      dq[static_cast<size_t>(q0 + i) * D + d] = s;
    });
    __syncthreads();                   // before the next tile's loads
  }
  // every rank's A and dE are in the scratch
  __threadfence();
  cluster_arrive();
  cluster_wait();

  // phase 2, per key tile of this rank; items (key tile, slab, query tile)
  {
    float* b2[2] = {sm, sm + pam_p2_buf(D)};
    // key tiles K = S - 1 - r, 2 S - 1 - r, ...: the ranks that took one
    // query tile more take one key tile less
    const int r2 = S - 1 - r;
    const int nkr = valid && r2 < nt ? (nt - r2 + S - 1) / S : 0;
    const int per = nsl2 * nt, n = nkr * per;
    auto issue = [&](int it) {
      const int kt = r2 + S * (it / per), sl = it % per / nt, qt = it % nt;
      const int k0 = kTP * kt, nk = tile(kt), q0 = kTP * qt, nq = tile(qt);
      const int c0 = kCS * sl;
      float* b = b2[it & 1];
      const int kw = (nk + 3) / 4 * 4;
      load_rows4(b, ld2, sa + static_cast<size_t>(q0) * sp, nq, kw, sp, k0);
      if (sl == 0) {
        load_rows4(b + kTP * ld2, ld2, sb + static_cast<size_t>(q0) * sp, nq,
                   kw, sp, k0);
        load_rows(b + 2 * kTP * ld2, ldq8, q + static_cast<size_t>(q0) * D,
                  nq, D);
      }
      load_rows4(b + 2 * kTP * ld2 + kTP * ldq8, ldy,
                 dy + static_cast<size_t>(q0) * C, nq, min(kCS, C - c0), C,
                 c0);
      mma3::cp_commit();
    };
    float av[1][4][4], ak[1][2][4];
    zero(av);
    zero(ak);
    const int nv0 = 32 * (warp >> 1), nd0 = 16 * (warp >> 1);
    const int ntd = min(2, max(0, (D - nd0 + 7) / 8));
    if (n > 0) issue(0);
    for (int it = 0; it < n; ++it) {
      mma3::cp_wait<0>();
      __syncthreads();                 // item it is in; it - 1 is done
      if (it + 1 < n) issue(it + 1);
      const int kt = r2 + S * (it / per), sl = it % per / nt, qt = it % nt;
      const int k0 = kTP * kt, nk = tile(kt), nq = tile(qt), c0 = kCS * sl;
      const int cw = min(kCS, C - c0);
      const int ntv = min(4, max(0, (cw - nv0) / 8));
      const float* b = b2[it & 1];
      // dv_K[:, slab] += A_QK^T dy_Q, dk_K += dE_QK^T q_Q (slab 0)
      if (ntv > 0) {
        warp_mma3(av, {View{b, 1, ld2, nk}}, {m0}, 1,
                  View{b + 2 * kTP * ld2 + kTP * ldq8, 1, ldy, cw}, nv0, nq,
                  ntv);
      }
      if (sl == 0 && ntd > 0) {
        warp_mma3(ak, {View{b + kTP * ld2, 1, ld2, nk}}, {m0}, 1,
                  View{b + 2 * kTP * ld2, 1, ldq8, D}, nd0, nq, ntd);
      }
      if (qt < nt - 1) continue;
      store_tile(av[0], m0, nv0, nk, min(cw, nv0 + 32),
                 [&](int i, int c, float s) {
                   dv[static_cast<size_t>(k0 + i) * C + c0 + c] = g * s;
                 });
      zero(av);
      if (sl == 0) {
        store_tile(ak[0], m0, nd0, nk, min(D, nd0 + 16),
                   [&](int i, int d, float s) {
                     dk[static_cast<size_t>(k0 + i) * D + d] = s;
                   });
        zero(ak);
      }
    }
  }
  const float total = block_sum(dg_part, red);
  if (valid && threadIdx.x == 0) *dg = total;
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


// Block (x, y), y < R = ceil(B Sp / S): PAM rank x % Sp of batch row
// y S / Sp + x / Sp, Sp = pam_ranks(P, C); y >= R: CAM rank x of batch
// row y - R; clusters of S = wide_ranks(C) blocks. The PAM rows come
// first: past one query tile they are the longer, and blocks start in
// row order. scratch: [B, 2, P,
// scratch_ld(P)] f32 for the PAM ranks. dgamma: [2, B, S]; [0, b, r] PAM
// rank r's share (zeros past Sp), [1, b, r] CAM rank r's.
template <int kCW>
__device__ __forceinline__ void wide_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ gp,
    const float* __restrict__ xc, const float* __restrict__ gc,
    const float* __restrict__ dyp, const float* __restrict__ dyc,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dxc, float* __restrict__ dgamma,
    float* __restrict__ scratch, int B, int P, int C, int D, int y0) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  const int S = wide_ranks(C), sp = pam_ranks(P, C);
  const int pam_rows = (B + S / sp - 1) / (S / sp);
  const int y = blockIdx.y + y0;
  if (y >= pam_rows) {
    const int b = y - pam_rows, rank = blockIdx.x;
    const size_t ov = static_cast<size_t>(b) * P * C;
    cam_rank_wide<kCW>(xc + ov, dyc + ov, gc[0], dxc + ov,
                       dgamma + static_cast<size_t>(B + b) * S + rank, P, C,
                       rank, S, sm, red);
    return;
  }
  const int rank = blockIdx.x % sp;
  const int b = y * (S / sp) + blockIdx.x / sp;
  const bool valid = b < B;
  const int bb = valid ? b : 0;
  const size_t ov = static_cast<size_t>(bb) * P * C;
  const size_t oq = static_cast<size_t>(bb) * P * D;
  float* share = dgamma + static_cast<size_t>(bb) * S;
  if (valid && rank == 0 && threadIdx.x >= sp && threadIdx.x < S) {
    share[threadIdx.x] = 0.f;
  }
  pam_rank_wide(q + oq, k + oq, v + ov, dyp + ov, gp[0], dq + oq, dk + oq,
                dv + ov, share + rank,
                scratch + static_cast<size_t>(bb) * 2 * P * scratch_ld(P), P,
                C, D, rank, sp, valid, sm, red);
}

#define WIDE_BWD_PARAMS                                                     \
  const float *__restrict__ q, const float *__restrict__ k,                 \
      const float *__restrict__ v, const float *__restrict__ gp,            \
      const float *__restrict__ xc, const float *__restrict__ gc,           \
      const float *__restrict__ dyp, const float *__restrict__ dyc,         \
      float *__restrict__ dq, float *__restrict__ dk, float *__restrict__ dv, \
      float *__restrict__ dxc, float *__restrict__ dgamma,                  \
      float *__restrict__ scratch, int B, int P, int C, int D, int y0

// Up to C = 256: two blocks an SM (128 registers, 103 KB). An earlier wide
// kernel at one block an SM (178 registers) held only 15 clusters of 8 at
// once and took 0.795 ms against 0.535 at B = 48, C = 512 (H100 80GB
// HBM3, 700 W).
__global__ void __launch_bounds__(kThreads, 2)
dual_attention_bwd_wide_kernel(WIDE_BWD_PARAMS) {
  wide_block<128>(q, k, v, gp, xc, gc, dyp, dyc, dq, dk, dv, dxc, dgamma,
                  scratch, B, P, C, D, y0);
}
// Past C = 256: the G and H rows (132 KB at C = 512) hold an SM alone, so
// the registers are not capped and the Gram chunks are 256 columns.
__global__ void __launch_bounds__(kThreads)
dual_attention_bwd_wide_c512(WIDE_BWD_PARAMS) {
  wide_block<256>(q, k, v, gp, xc, gc, dyp, dyc, dq, dk, dv, dxc, dgamma,
                  scratch, B, P, C, D, y0);
}

bool narrow(int P, int C, int D) {
  return P <= kNarrowP && C <= kNarrowC && D <= kNarrowD;
}

bool takes(int P, int C, int D) {
  return P >= 1 && C >= kRows && C <= kMaxC && C % kRows == 0 && D >= 1 &&
         D <= kMaxD;
}

int cluster_size(int P, int C, int D) {
  return narrow(P, C, D) ? C / kRows : wide_ranks(C);
}

// The wide kernel for C.
const void* wide_kernel(int C) {
  return C > 256 ? reinterpret_cast<const void*>(dual_attention_bwd_wide_c512)
                 : reinterpret_cast<const void*>(dual_attention_bwd_wide_kernel);
}

// Opts the kernels in to the dynamic shared memory of the largest shape
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
  const size_t w128 = wide_smem_bytes(128, kMaxD), w256 = wide_smem_bytes(256, kMaxD);
  const struct {
    const void* kernel;
    size_t smem;
  } all[3] = {
      {reinterpret_cast<const void*>(dual_attention_bwd_kernel),
       smem_bytes(kNarrowP, kNarrowC, kNarrowD)},
      {reinterpret_cast<const void*>(dual_attention_bwd_wide_kernel),
       w128 > w256 ? w128 : w256},
      {reinterpret_cast<const void*>(dual_attention_bwd_wide_c512),
       wide_smem_bytes(kMaxC, kMaxD)}};
  for (const auto& a : all) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(a.kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(a.smem));
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(a.kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The launch of B batch rows in clusters of (S, 1, 1), S =
// cluster_size(P, C, D): the first kernel's grid of (S, B + ceil(B / S))
// blocks, the wide kernel's of (S, ceil(B Sp / S) + B), Sp = pam_ranks;
// sides 1 launches the wide kernel's CAM rows alone, 2 its PAM rows (the
// returned y0 is the first row's index), 3 both.
int configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B,
              int P, int C, int D, cudaStream_t stream, int sides = 3) {
  const int size = cluster_size(P, C, D);
  const bool first = narrow(P, C, D);
  const int rows = first ? size : size / pam_ranks(P, C);
  const int pam = (B + rows - 1) / rows;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(size, (sides & 1 ? B : 0) + (sides & 2 ? pam : 0), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = first ? smem_bytes(P, C, D) : wide_smem_bytes(C, D);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return sides == 1 ? pam : 0;         // the wide kernel's first row
}

// One launch of the backward; sides as in configure (the wide kernel).
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* gamma_pam, const void* x_cam,
                   const void* gamma_cam, const void* dy_pam,
                   const void* dy_cam, void* dq, void* dk, void* dv,
                   void* dx_cam, void* dgamma, void* scratch, int B, int P,
                   int C, int D, int sides, void* stream) {
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int y0 =
      configure(cfg, attr, B, P, C, D, static_cast<cudaStream_t>(stream), sides);
  const float* args[8] = {
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(gamma_pam),
      static_cast<const float*>(x_cam), static_cast<const float*>(gamma_cam),
      static_cast<const float*>(dy_pam), static_cast<const float*>(dy_cam)};
  if (narrow(P, C, D)) {
    return cudaLaunchKernelEx(
        &cfg, dual_attention_bwd_kernel, args[0], args[1], args[2], args[3],
        args[4], args[5], args[6], args[7], static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(dx_cam), static_cast<float*>(dgamma), B, P, C, D);
  }
  return cudaLaunchKernelEx(
      &cfg,
      C > 256 ? dual_attention_bwd_wide_c512 : dual_attention_bwd_wide_kernel,
      args[0], args[1], args[2], args[3], args[4], args[5], args[6], args[7],
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dx_cam),
      static_cast<float*>(dgamma), static_cast<float*>(scratch), B, P, C, D,
      y0);
}

}  // namespace

// q, k, dq, dk: [B, P, D]; v, x_cam, dy_pam, dy_cam, dv, dx_cam: [B, P, C];
// gamma_pam, gamma_cam: [1]; all f32, contiguous, on the device; v, x_cam,
// dy_pam, dy_cam and dx_cam 16-byte aligned. dgamma: [2, B * S] f32,
// S = dual_attention_bwd_cluster_size(P, C, D); row 0 gets the PAM
// shares of dgamma_pam (the first kernel: one a batch row, then S - 1
// zeros; the wide one: one a PAM rank, then zeros), row 1 each CAM
// rank's share of
// dgamma_cam, so that one sum over the last axis gives both. scratch:
// [B, 2, P, (P + 3) / 4 * 4] f32, 16-byte aligned, read only by the wide
// kernel (P > 64, C > 128 or D > 32). P >= 1, C a multiple of 32 up to
// 512, 1 <= D <= 64 (the wrapper checks). Returns cudaGetLastError() (or
// the error of the shared-memory opt-in or of the launch).
extern "C" int dual_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* gamma_pam,
    const void* x_cam, const void* gamma_cam, const void* dy_pam,
    const void* dy_cam, void* dq, void* dk, void* dv, void* dx_cam,
    void* dgamma, void* scratch, int B, int P, int C, int D, void* stream) {
  if (!takes(P, C, D) || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      launch(q, k, v, gamma_pam, x_cam, gamma_cam, dy_pam, dy_cam, dq, dk, dv,
             dx_cam, dgamma, scratch, B, P, C, D, 3, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One side of the wide kernel alone (sides 1: the CAM clusters, 2: the
// PAM clusters), the arguments as dual_attention_bwd_f32's, which
// chip_smoke.py times to see which side sets a shape's pace; the other
// side's outputs are left unwritten. Refuses (cudaErrorInvalidValue) a
// shape of the first kernel.
extern "C" int dual_attention_bwd_side(
    const void* q, const void* k, const void* v, const void* gamma_pam,
    const void* x_cam, const void* gamma_cam, const void* dy_pam,
    const void* dy_cam, void* dq, void* dk, void* dv, void* dx_cam,
    void* dgamma, void* scratch, int B, int P, int C, int D, int sides,
    void* stream) {
  if (!takes(P, C, D) || B < 1 || narrow(P, C, D) || sides < 1 || sides > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      launch(q, k, v, gamma_pam, x_cam, gamma_cam, dy_pam, dy_cam, dq, dk, dv,
             dx_cam, dgamma, scratch, B, P, C, D, sides, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one block uses, which chip_smoke.py
// reports beside the kernel's times; -1 for a shape it does not take.
extern "C" long long dual_attention_bwd_smem_bytes(int P, int C, int D) {
  if (!takes(P, C, D)) return -1;
  return static_cast<long long>(narrow(P, C, D) ? smem_bytes(P, C, D)
                                                : wide_smem_bytes(C, D));
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
          : wide_kernel(C),
      &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
