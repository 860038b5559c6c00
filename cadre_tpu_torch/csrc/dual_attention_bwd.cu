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

#include "fork.cuh"
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
// while the current one is multiplied, one barrier a tile). It is two
// launches side by side (fork.cuh: the PAM launch on a second stream,
// forked from the caller's and joined back), each with its own clusters,
// shared memory and registers. Per batch row a cluster of S = C / 32 CAM
// ranks (16 at C = 512, a non-portable cluster: one 32-row group a rank,
// where two groups a rank in clusters of 8 cost 7 C^2 P a row against 5
// and left the last of four waves a tenth full; a card that cannot hold a
// cluster of 16 such blocks, 16 SMs of one GPC, runs C > 256 in portable
// clusters of 8 ranks of up to two groups each: cam_ranks), and a cluster of Sp PAM
// ranks (one per query tile, at most 8, and at most 1.5 blocks an SM over
// the launch: pam_ranks):
// - CAM rank r owns groups g = r, r + S, ... of Gram rows and of dx_c
//   columns (one group but in clusters of 8 past C = 256). Pass 1, per group:
//   G[g, :] = x_g^T x and H[g, :] = dy_g^T x summed over the position
//   tiles, in chunks of 128 columns (256 above C = 256), into the group's
//   [32, C] G and H rows in shared memory; then each row's min mu_i (the
//   softmax of rowmax(G) - G is exp(mu_i - G_ij) / S_i), S_i = sum_j
//   exp(mu_i - G_ij) and W_i = sum_j H_ij exp(mu_i - G_ij), dot_i = gc W_i
//   / S_i and the rank's share of dgc, sum_i W_i / S_i. Each rank stores
//   (mu, 1 / S, dot) of its rows into every rank's shared memory
//   (distributed shared memory: 3 C floats a rank). Pass 2 (its G and H
//   are still in shared memory): H[c, g]^T = x_g^T dy_c over the position
//   tiles, and from it, G and H and every row's statistics, M = gc Bm[c,
//   g] and N = dN[c, g] + dN[g, c]^T over G and H in place (as M^T and
//   N^T); then per position tile and chunk of 128 channels, dx_c[p, g] =
//   dy[p, g] + sum_c (dy[p, c] M[c, g] - x[p, c] N[c, g]), each warp a
//   16-channel slice of the chunk over the whole tile (eight independent
//   sums, where one m16n8 tile a warp over all of C was a serial chain),
//   the warps' sums added in warp order. That is 5 C^2 P multiply-adds a
//   row, as the narrow kernel's, for no [P, C] exchange.
// - PAM rank r of a row takes query tiles Q = r, r + Sp, ... in phase 1,
//   then key tiles K = Sp - 1 - r, 2 Sp - 1 - r, ... in phase 2 (so that
//   a rank with one query tile more has one key tile less), the two
//   phases split by a cluster barrier; A and dE go between them through a
//   [B, 2, P, P'] f32 scratch the wrapper allocates (P' = P rounded up to
//   4; 1.81 MB a row at P = 475). Phase 1, per query tile: over the key
//   tiles, E = q_Q k_K^T and G = dy_Q v_K^T (dy and v in slabs of 128
//   channels, or dy_Q kept whole for the query tile up to C = 128), and
//   from the mma fragments each thread's running max, sum of exp(E - max)
//   and sum of exp(E - max) G over the columns it holds, rescaled as its
//   max rises (the row's statistics are formed once a query tile over its
//   16 threads, not once a key tile), E and G from the fragments to the
//   scratch;
//   D_i = (sum of exp(E - m) G) / l = sum_j A_ij G_ij (the flash-attention
//   identity rowsum(dA * A)_i = gp D_i); then over the key tiles again, A
//   = exp(E - m) / l and dE = A (gp G - gp D_i) from the scratch, A and dE
//   stored over E and G, and dq_Q += dE_QK k_K. Phase 2, per pair of key
//   tiles: dk_K = sum_Q dE_QK^T q_Q and dv_K = gp sum_Q A_QK^T dy_Q (dy in
//   slabs of 128 channels), read back from the scratch after the cluster
//   barrier, each fragment of dy and q feeding both key tiles. The
//   attention is still recomputed from the inputs, not saved by the
//   forward; the scratch lives for the call only.
// Shared memory: 103 KB up to C = 256 (two blocks an SM), 226 KB at
// C = 512 (one) for a CAM rank; at most 103 KB for a PAM rank (two),
// whatever P. Gamma shares [2, B, R], R = max(S, 8), one per rank.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py --kernel-times,
// graph ms at B = 48): P = 475 C = 128 0.8489, its PAM ranks setting the
// pace (latency-bound: each rank's phases a serial chain of 32-key
// tiles), C = 512 5.1211, its CAM clusters setting it (bound by the 5 C^2
// P multiply-adds in 3xTF32); P = 144 0.1824; C = 512, P = 40 0.5413. The
// sides alone and the rest: PERF.md (phase 3).

constexpr int kTP = 32;          // queries or keys of a PAM tile
constexpr int kKC = 128;         // channels of a dx_c chunk (CAM)
constexpr int kCS = 128;         // channels of a dy and v slab (PAM)
constexpr int kKG = 2;           // key tiles a PAM rank takes at once (phase 2)
constexpr int kMaxPam = 8;       // PAM ranks of a row (a portable cluster)
constexpr int kPortable = 8;     // the largest portable cluster

// CAM ranks of a batch row: one per 32-row group (16 at C = 512, a
// non-portable cluster)
__host__ __device__ inline int wide_ranks(int C) { return C / kRows; }
// PAM ranks of a batch row: one per query tile, at most kMaxPam, and no
// more than B rows of them make `slots` blocks. A rank's phases are a
// serial chain of tiles, so more ranks shorten the pass while the card has
// room; the launch passes 1.5 blocks an SM, past which more ranks
// lengthened the pass on an H100.
inline int pam_ranks(int P, int B, int slots) {
  const int nt = (P + kTP - 1) / kTP, fit = B > 0 ? slots / B : kMaxPam;
  int sp = nt < kMaxPam ? nt : kMaxPam;
  if (fit < sp) sp = fit > 1 ? fit : 1;
  return sp;
}
// gamma shares of a batch row in each of dgamma's two rows
__host__ __device__ inline int wide_shares(int C) {
  const int s = wide_ranks(C);
  return s > kMaxPam ? s : kMaxPam;
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
// A PAM rank, phase 1: the q tile; up to C = 128 dy's rows of the query
// tile (all C channels, kept for every key tile); two buffers, each a
// [32, D] k tile and a [32, cs] slab of v and, past C = 128, one of dy;
// the rows' statistics from each warp. Phase 2: two buffers, each [32,
// 64] tiles of A and
// dE (kKG key tiles), a [32, D] q tile and a [32, 128] slab of dy.
__host__ __device__ inline int pam_p1_buf(int C, int D) {
  const int cs = C < kCS ? C : kCS;
  return kTP * (ld4(D) + (C <= kCS ? 1 : 2) * ld4(cs));
}
__host__ __device__ inline int pam_p2_buf(int D) {
  return kTP * (2 * ld8(kKG * kTP) + ld8(D) + ld8(kCS));
}
__host__ __device__ inline size_t pam_wide_floats(int C, int D) {
  const size_t p1 = kTP * ld4(D) + (C <= kCS ? kTP * ld4(C) : 0) +
                    2 * pam_p1_buf(C, D) + kTP * ld4(kTP);
  const size_t p2 = 2 * static_cast<size_t>(pam_p2_buf(D));
  return p1 > p2 ? p1 : p2;
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
// row's [2][P][P'] scratch. q, k, dq, dk: [P, D]; v, dy, dv: [P, C].
__device__ void pam_rank_wide(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dy, float g,
                              float* __restrict__ dq, float* __restrict__ dk,
                              float* __restrict__ dv, float* __restrict__ dg,
                              float* __restrict__ scr, int P, int C, int D,
                              int r, int S, float* sm, float* red) {
  constexpr int ldt = ld4(kTP);        // E, G and dE tiles
  constexpr int ld2 = ld8(kKG * kTP);  // phase 2's A and dE tiles
  constexpr int ldy = ld8(kCS);        // phase 2's dy slab
  constexpr int kR = kTP / kWarps;     // rows of a warp (statistics)
  const int ldq = ld4(D), ldq8 = ld8(D), cs = min(C, kCS), lds = ld4(cs);
  const int sp = scratch_ld(P), nt = (P + kTP - 1) / kTP;
  const int nsl = (C + cs - 1) / cs, nsl2 = (C + kCS - 1) / kCS;
  const bool kept = C <= kCS;          // dy_Q kept for the query tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);
  float* sa = scr;                     // [P][sp]: E, then A
  float* sb = scr + static_cast<size_t>(P) * sp;   // [P][sp]: G, then dE
  auto tile = [&](int t) { return min(kTP, P - t * kTP); };
  float dg_part = 0.f;

  // phase 1, per query tile of this rank
  float* qs = sm;                      // [32][ldq]
  float* dyq = qs + kTP * ldq;         // [32][lds] when kept
  float* b1[2] = {dyq + (kept ? kTP * lds : 0),
                  dyq + (kept ? kTP * lds : 0) + pam_p1_buf(C, D)};
  float* te = b1[0] + 2 * pam_p1_buf(C, D);   // the statistics' exchange
  for (int qt = r; qt < nt; qt += S) {
    const int q0 = kTP * qt, nq = tile(qt);
    // (a) items (key tile, slab of v and, unless kept, of dy): a buffer
    // holds the k tile, then the v slab, then the dy slab
    const int n = nt * nsl;
    auto issue = [&](int it) {
      const int kt = it / nsl, c0 = cs * (it % nsl), nk = tile(kt);
      float* kb = b1[it & 1];
      if (it == 0) {
        load_rows(qs, ldq, q + static_cast<size_t>(q0) * D, nq, D);
        if (kept) {
          load_rows4(dyq, lds, dy + static_cast<size_t>(q0) * C, nq, C, C, 0);
        }
      }
      if (it % nsl == 0) {
        load_rows(kb, ldq, k + static_cast<size_t>(kt) * kTP * D, nk, D);
      }
      load_rows4(kb + kTP * ldq, lds, v + static_cast<size_t>(kt) * kTP * C,
                 nk, min(cs, C - c0), C, c0);
      if (!kept) {
        load_rows4(kb + kTP * ldq + kTP * lds, lds,
                   dy + static_cast<size_t>(q0) * C, nq, min(cs, C - c0), C,
                   c0);
      }
      mma3::cp_commit();
    };
    float ae[1][1][4], ag[1][1][4];
    zero(ae);
    zero(ag);
    // this thread's running max, sum of exp(E - max) and sum of exp(E -
    // max) G over its columns (n0 + 2 t, n0 + 2 t + 1 of each key tile)
    // of its two rows (m0 + g, m0 + g + 8), rescaled as its max rises
    const int gq = lane >> 2, t2 = 2 * (lane & 3);
    float tm[2] = {-INFINITY, -INFINITY}, tl[2] = {0.f, 0.f},
          tw[2] = {0.f, 0.f};
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
      warp_mma3(ag, {View{kept ? dyq : kb + kTP * ldq + kTP * lds, lds, 1, nq}},
                {m0}, 1, View{kb + kTP * ldq, lds, 1, nk}, n0,
                min(cs, C - cs * sl));
      if (sl < nsl - 1) continue;
      // the key tile's E and G are whole: the statistics of this thread's
      // elements, and E and G to the scratch, straight from the fragments
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0 + gq + 8 * h, j = n0 + t2;
        if (i >= nq) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (j + c >= nk) continue;
          const float e = ae[0][0][2 * h + c], gv = ag[0][0][2 * h + c];
          if (e > tm[h]) {
            const float scale = expf(tm[h] - e);   // 0 at the first
            tl[h] = tl[h] * scale + 1.f;
            tw[h] = tw[h] * scale + gv;
            tm[h] = e;
          } else {
            const float p = expf(e - tm[h]);
            tl[h] += p;
            tw[h] = fmaf(p, gv, tw[h]);
          }
        }
        const size_t o = static_cast<size_t>(q0 + i) * sp + k0 + j;
        if (j + 1 < nk) {
          __stcg(reinterpret_cast<float2*>(sa + o),
                 make_float2(ae[0][0][2 * h], ae[0][0][2 * h + 1]));
          __stcg(reinterpret_cast<float2*>(sb + o),
                 make_float2(ag[0][0][2 * h], ag[0][0][2 * h + 1]));
        } else if (j < nk) {
          __stcg(sa + o, ae[0][0][2 * h]);
          __stcg(sb + o, ag[0][0][2 * h]);
        }
      }
      zero(ae);
      zero(ag);
    }
    // each row's max, sum l and D = w / l (sum_j A_ij G_ij): the 4 lanes
    // of a row in the fragment, then the 4 warps of its m-tile through
    // shared memory (te), then into the rows of (b)'s layout (warp + 8 rr)
    float* part = te;                  // [4 n-groups][32 rows][3]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mm = tm[h];
      for (int o = 1; o < 4; o <<= 1) {
        mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
      }
      const float f = tm[h] == -INFINITY ? 0.f : expf(tm[h] - mm);
      float ll = tl[h] * f, ww = tw[h] * f;
      for (int o = 1; o < 4; o <<= 1) {
        ll += __shfl_xor_sync(0xffffffffu, ll, o);
        ww += __shfl_xor_sync(0xffffffffu, ww, o);
      }
      if ((lane & 3) == 0) {
        float* pp = part + ((warp >> 1) * kTP + m0 + gq + 8 * h) * 3;
        pp[0] = mm;
        pp[1] = ll;
        pp[2] = ww;
      }
    }
    __syncthreads();
    float m[kR], l[kR], dd[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int i = warp + kWarps * rr;
      float mm = -INFINITY;
#pragma unroll
      for (int q = 0; q < 4; ++q) mm = fmaxf(mm, part[(q * kTP + i) * 3]);
      float ll = 0.f, ww = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* pp = part + (q * kTP + i) * 3;
        const float f = pp[0] == -INFINITY ? 0.f : expf(pp[0] - mm);
        ll = fmaf(pp[1], f, ll);
        ww = fmaf(pp[2], f, ww);
      }
      m[rr] = mm;
      l[rr] = ll;
      // D_i = sum_j A_ij G_ij; this rank's share of dgp is their sum
      dd[rr] = i < nq ? ww / ll : 0.f;
      if (lane == 0 && i < nq) dg_part += dd[rr];
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

  // phase 2, per group of kKG key tiles of this rank; items (group, slab,
  // query tile)
  {
    float* b2[2] = {sm, sm + pam_p2_buf(D)};
    // key tiles K = S - 1 - r, 2 S - 1 - r, ...: the ranks that took one
    // query tile more take one key tile less
    const int r2 = S - 1 - r;
    const int nkr = r2 < nt ? (nt - r2 + S - 1) / S : 0;
    const int ngr = (nkr + kKG - 1) / kKG;
    const int per = nsl2 * nt, n = ngr * per;
    auto ktile = [&](int gi, int j) { return r2 + S * (kKG * gi + j); };
    auto tiles_in = [&](int gi) { return min(kKG, nkr - kKG * gi); };
    // a buffer: A [32 q][ld2] (key tile j at column 32 j), dE likewise, the
    // q tile, the dy slab
    auto issue = [&](int it) {
      const int gi = it / per, sl = it % per / nt, qt = it % nt;
      const int q0 = kTP * qt, nq = tile(qt), c0 = kCS * sl;
      float* b = b2[it & 1];
      for (int j = 0; j < tiles_in(gi); ++j) {
        const int kt = ktile(gi, j), k0 = kTP * kt;
        const int kw = (tile(kt) + 3) / 4 * 4;
        load_rows4(b + kTP * j, ld2, sa + static_cast<size_t>(q0) * sp, nq,
                   kw, sp, k0);
        if (sl == 0) {
          load_rows4(b + kTP * ld2 + kTP * j, ld2,
                     sb + static_cast<size_t>(q0) * sp, nq, kw, sp, k0);
        }
      }
      if (sl == 0) {
        load_rows(b + 2 * kTP * ld2, ldq8, q + static_cast<size_t>(q0) * D,
                  nq, D);
      }
      load_rows4(b + 2 * kTP * ld2 + kTP * ldq8, ldy,
                 dy + static_cast<size_t>(q0) * C, nq, min(kCS, C - c0), C,
                 c0);
      mma3::cp_commit();
    };
    float av[kKG][4][4], ak[kKG][2][4];
    zero(av);
    zero(ak);
    const int nv0 = 32 * (warp >> 1), nd0 = 16 * (warp >> 1);
    const int ntd = min(2, max(0, (D - nd0 + 7) / 8));
    if (n > 0) issue(0);
    for (int it = 0; it < n; ++it) {
      mma3::cp_wait<0>();
      __syncthreads();                 // item it is in; it - 1 is done
      if (it + 1 < n) issue(it + 1);
      const int gi = it / per, sl = it % per / nt, qt = it % nt;
      const int nq = tile(qt), c0 = kCS * sl, cw = min(kCS, C - c0);
      const int ntv = min(4, max(0, (cw - nv0) / 8)), mt = tiles_in(gi);
      const float* b = b2[it & 1];
      // dv_K[:, slab] += A_QK^T dy_Q, dk_K += dE_QK^T q_Q (slab 0), the
      // group's key tiles sharing each fragment of dy and q
      View va[kKG], ve[kKG];
      int mm0[kKG];
#pragma unroll
      for (int j = 0; j < kKG; ++j) {
        const int nk = j < mt ? tile(ktile(gi, j)) : 1;
        va[j] = View{b + kTP * j, 1, ld2, nk};
        ve[j] = View{b + kTP * ld2 + kTP * j, 1, ld2, nk};
        mm0[j] = m0;
      }
      if (ntv > 0) {
        warp_mma3(av, va, mm0, mt,
                  View{b + 2 * kTP * ld2 + kTP * ldq8, 1, ldy, cw}, nv0, nq,
                  ntv);
      }
      if (sl == 0 && ntd > 0) {
        warp_mma3(ak, ve, mm0, mt, View{b + 2 * kTP * ld2, 1, ldq8, D}, nd0,
                  nq, ntd);
      }
      if (qt < nt - 1) continue;
      for (int j = 0; j < mt; ++j) {
        const int k0 = kTP * ktile(gi, j), nk = tile(ktile(gi, j));
        store_tile(av[j], m0, nv0, nk, min(cw, nv0 + 32),
                   [&](int i, int c, float s) {
                     dv[static_cast<size_t>(k0 + i) * C + c0 + c] = g * s;
                   });
        if (sl == 0) {
          store_tile(ak[j], m0, nd0, nk, min(D, nd0 + 16),
                     [&](int i, int d, float s) {
                       dk[static_cast<size_t>(k0 + i) * D + d] = s;
                     });
        }
      }
      zero(av);
      if (sl == 0) zero(ak);
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


// The wide kernel is two launches, each with its own clusters, shared
// memory and registers, which run side by side (fork.cuh): the PAM
// ranks, block (r, b) PAM rank r of batch row b in clusters of Sp =
// pam_ranks(P); the CAM ranks, block (r, b) CAM rank r of batch row b in
// clusters of S = wide_ranks(C). scratch: [B, 2, P, scratch_ld(P)] f32 for the PAM ranks.
// dgamma: [2, B, R], R = wide_shares(C); [0, b, r] PAM rank r's share,
// [1, b, r] CAM rank r's, zeros past Sp and S (written by each side's
// rank 0).
#define WIDE_BWD_PARAMS                                                     \
  const float *__restrict__ q, const float *__restrict__ k,                 \
      const float *__restrict__ v, const float *__restrict__ gp,            \
      const float *__restrict__ xc, const float *__restrict__ gc,           \
      const float *__restrict__ dyp, const float *__restrict__ dyc,         \
      float *__restrict__ dq, float *__restrict__ dk, float *__restrict__ dv, \
      float *__restrict__ dxc, float *__restrict__ dgamma,                  \
      float *__restrict__ scratch, int B, int P, int C, int D

template <int kCW>
__device__ __forceinline__ void cam_block_wide(WIDE_BWD_PARAMS) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  const int S = gridDim.x, R = wide_shares(C);   // S: cam_ranks
  const int b = blockIdx.y, rank = blockIdx.x;
  const size_t ov = static_cast<size_t>(b) * P * C;
  float* share = dgamma + static_cast<size_t>(B + b) * R;
  if (rank == 0 && threadIdx.x >= S && threadIdx.x < R) share[threadIdx.x] = 0.f;
  cam_rank_wide<kCW>(xc + ov, dyc + ov, gc[0], dxc + ov, share + rank, P, C,
                     rank, S, sm, red);
}

// Up to C = 256: two blocks an SM (128 registers, 103 KB). An earlier wide
// kernel at one block an SM (178 registers) held only 15 clusters of 8 at
// once and took 0.795 ms against 0.535 at B = 48, C = 512 (H100 80GB
// HBM3, 700 W).
__global__ void __launch_bounds__(kThreads, 2)
dual_attention_bwd_wide_cam(WIDE_BWD_PARAMS) {
  cam_block_wide<128>(q, k, v, gp, xc, gc, dyp, dyc, dq, dk, dv, dxc, dgamma,
                      scratch, B, P, C, D);
}
// Past C = 256: the G and H rows (132 KB at C = 512) hold an SM alone, so
// the registers are not capped and the Gram chunks are 256 columns; one
// 32-row group a rank, in clusters of up to 16 (non-portable), or two
// groups a rank in clusters of 8 (cam_ranks).
__global__ void __launch_bounds__(kThreads)
dual_attention_bwd_wide_cam512(WIDE_BWD_PARAMS) {
  cam_block_wide<256>(q, k, v, gp, xc, gc, dyp, dyc, dq, dk, dv, dxc, dgamma,
                      scratch, B, P, C, D);
}
// The PAM ranks: two blocks an SM (at most 103 KB).
__global__ void __launch_bounds__(kThreads, 2)
dual_attention_bwd_wide_pam(WIDE_BWD_PARAMS) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kWarps];
  const int sp = gridDim.x, R = wide_shares(C);   // sp: pam_ranks
  const int b = blockIdx.y, rank = blockIdx.x;
  const size_t ov = static_cast<size_t>(b) * P * C;
  const size_t oq = static_cast<size_t>(b) * P * D;
  float* share = dgamma + static_cast<size_t>(b) * R;
  if (rank == 0 && threadIdx.x >= sp && threadIdx.x < R) share[threadIdx.x] = 0.f;
  pam_rank_wide(q + oq, k + oq, v + ov, dyp + ov, gp[0], dq + oq, dk + oq,
                dv + ov, share + rank,
                scratch + static_cast<size_t>(b) * 2 * P * scratch_ld(P), P, C,
                D, rank, sp, sm, red);
}

bool narrow(int P, int C, int D) {
  return P <= kNarrowP && C <= kNarrowC && D <= kNarrowD;
}

bool takes(int P, int C, int D) {
  return P >= 1 && C >= kRows && C <= kMaxC && C % kRows == 0 && D >= 1 &&
         D <= kMaxD;
}

size_t cam_smem(int C) { return cam_wide_floats(C) * sizeof(float); }
size_t pam_smem(int C, int D) { return pam_wide_floats(C, D) * sizeof(float); }

// A launch of `rows` grid rows of `size` blocks, in clusters of `size`,
// with `smem` bytes of dynamic shared memory a block.
void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int size,
               int rows, size_t smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(size, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Devices that can hold a cluster of 16 C = 512 CAM ranks (bit dev & 63),
// found by opt_in_smem.
std::atomic<unsigned long long> holds16{0};

// Opts the kernels in to the dynamic shared memory of the largest shape
// each takes, to the largest shared-memory carveout and (the CAM kernel
// past C = 256) to clusters of 16, and asks whether the device can hold
// one such cluster at C = 512 (16 blocks of 226 KB: 16 SMs of one GPC),
// once per device (the attributes are the device's, so later launches
// there skip the host calls).
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const size_t c128 = cam_smem(128), c256 = cam_smem(256);
  const size_t p128 = pam_smem(128, kMaxD), p512 = pam_smem(kMaxC, kMaxD);
  const struct {
    const void* kernel;
    size_t smem;
  } all[4] = {
      {reinterpret_cast<const void*>(dual_attention_bwd_kernel),
       smem_bytes(kNarrowP, kNarrowC, kNarrowD)},
      {reinterpret_cast<const void*>(dual_attention_bwd_wide_cam),
       c128 > c256 ? c128 : c256},
      {reinterpret_cast<const void*>(dual_attention_bwd_wide_cam512),
       cam_smem(kMaxC)},
      {reinterpret_cast<const void*>(dual_attention_bwd_wide_pam),
       p128 > p512 ? p128 : p512}};
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
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(dual_attention_bwd_wide_cam512),
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, wide_ranks(kMaxC), 1, cam_smem(kMaxC), nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, reinterpret_cast<const void*>(dual_attention_bwd_wide_cam512),
          &cfg) != cudaSuccess) {
    n = 0;
    cudaGetLastError();                // a size the device refuses: 8
  }
  if (n > 0) holds16.fetch_or(bit, std::memory_order_release);
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

// CAM ranks of a batch row of the wide kernel (after opt_in_smem): one
// per 32-row group where the device holds such clusters, else (past C =
// 256, or `portable`) portable clusters of 8.
int cam_ranks(int C, bool portable) {
  int dev = 0;
  const bool big = !portable && cudaGetDevice(&dev) == cudaSuccess &&
                   (holds16.load(std::memory_order_acquire) >> (dev & 63) & 1);
  const int s = wide_ranks(C);
  return s > kPortable && !big ? kPortable : s;
}

// Blocks in one CAM cluster of a launch (after opt_in_smem).
int cluster_size(int P, int C, int D) {
  return narrow(P, C, D) ? C / kRows : cam_ranks(C, false);
}

// One launch of the backward: the first kernel's grid of (S, B +
// ceil(B / S)) blocks in clusters of S = C / 32, or the wide kernel's two
// launches (sides 1: the CAM ranks alone, 2: the PAM ranks alone, 3: both;
// | 4: the CAM ranks in portable clusters of 8 past C = 256, the layout of
// a card that cannot hold 16).
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* gamma_pam, const void* x_cam,
                   const void* gamma_cam, const void* dy_pam,
                   const void* dy_cam, void* dq, void* dk, void* dv,
                   void* dx_cam, void* dgamma, void* scratch, int B, int P,
                   int C, int D, int sides, void* stream) {
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const float* in[8] = {
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(gamma_pam),
      static_cast<const float*>(x_cam), static_cast<const float*>(gamma_cam),
      static_cast<const float*>(dy_pam), static_cast<const float*>(dy_cam)};
  float* out[6] = {static_cast<float*>(dq), static_cast<float*>(dk),
                   static_cast<float*>(dv), static_cast<float*>(dx_cam),
                   static_cast<float*>(dgamma), static_cast<float*>(scratch)};
  if (narrow(P, C, D)) {
    const int size = C / kRows;
    configure(cfg, attr, size, B + (B + size - 1) / size, smem_bytes(P, C, D),
              st);
    return cudaLaunchKernelEx(&cfg, dual_attention_bwd_kernel, in[0], in[1],
                              in[2], in[3], in[4], in[5], in[6], in[7],
                              out[0], out[1], out[2], out[3], out[4], B, P, C,
                              D);
  }
  // both sides: the PAM launch beside the CAM launch (fork.cuh), joined
  // back on every path once forked
  const bool both = (sides & 3) == 3;
  fork2::Side* sd = nullptr;
  cudaStream_t pst = st;
  if (both) {
    err = fork2::fork(st, &sd);
    if (err != cudaSuccess) return err;
    pst = sd->stream;
  }
  if (sides & 2) {
    configure(cfg, attr, pam_ranks(P, B, 3 * fork2::sm_count() / 2), B,
              pam_smem(C, D), pst);
    err = cudaLaunchKernelEx(&cfg, dual_attention_bwd_wide_pam, in[0], in[1],
                             in[2], in[3], in[4], in[5], in[6], in[7], out[0],
                             out[1], out[2], out[3], out[4], out[5], B, P, C,
                             D);
  }
  if (err == cudaSuccess && (sides & 1)) {
    configure(cfg, attr, cam_ranks(C, sides & 4), B, cam_smem(C), st);
    err = cudaLaunchKernelEx(
        &cfg,
        C > 256 ? dual_attention_bwd_wide_cam512 : dual_attention_bwd_wide_cam,
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0],
        out[1], out[2], out[3], out[4], out[5], B, P, C, D);
  }
  if (both) {
    const cudaError_t joined = fork2::join(st, sd);
    if (err == cudaSuccess) err = joined;
  }
  return err;
}

}  // namespace

// q, k, dq, dk: [B, P, D]; v, x_cam, dy_pam, dy_cam, dv, dx_cam: [B, P, C];
// gamma_pam, gamma_cam: [1]; all f32, contiguous, on the device; v, x_cam,
// dy_pam, dy_cam and dx_cam 16-byte aligned. dgamma: [2, B * R] f32,
// R = dual_attention_bwd_shares(P, C, D); row 0 gets the PAM shares of
// dgamma_pam (the first kernel: one a batch row, then R - 1 zeros; the
// wide one: one a PAM rank, then zeros), row 1 each CAM rank's share of
// dgamma_cam (then zeros), so that one sum over the last axis gives both.
// scratch: [B, 2, P, (P + 3) / 4 * 4] f32, 16-byte aligned, read only by
// the wide kernel (P > 64, C > 128 or D > 32). P >= 1, C a multiple of 32
// up to 512, 1 <= D <= 64 (the wrapper checks). Returns
// cudaGetLastError() (or the error of the shared-memory opt-in or of a
// launch).
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
// side's outputs are left unwritten. sides | 4: the CAM clusters portable
// (8 ranks past C = 256), which chip_smoke.py holds to the plain version
// on a card that runs clusters of 16. Refuses (cudaErrorInvalidValue) a
// shape of the first kernel.
extern "C" int dual_attention_bwd_side(
    const void* q, const void* k, const void* v, const void* gamma_pam,
    const void* x_cam, const void* gamma_cam, const void* dy_pam,
    const void* dy_cam, void* dq, void* dk, void* dv, void* dx_cam,
    void* dgamma, void* scratch, int B, int P, int C, int D, int sides,
    void* stream) {
  if (!takes(P, C, D) || B < 1 || narrow(P, C, D) || (sides & 3) == 0 ||
      sides > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      launch(q, k, v, gamma_pam, x_cam, gamma_cam, dy_pam, dy_cam, dq, dk, dv,
             dx_cam, dgamma, scratch, B, P, C, D, sides, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one block uses (the wide kernel: the
// larger of its two launches'), which chip_smoke.py reports beside the
// kernel's times; -1 for a shape it does not take.
extern "C" long long dual_attention_bwd_smem_bytes(int P, int C, int D) {
  if (!takes(P, C, D)) return -1;
  if (narrow(P, C, D)) return static_cast<long long>(smem_bytes(P, C, D));
  const size_t a = cam_smem(C), b = pam_smem(C, D);
  return static_cast<long long>(a > b ? a : b);
}

// Blocks in one CAM cluster (S) on the current device; -1 for a shape
// the kernel does not take, or minus the CUDA error.
extern "C" int dual_attention_bwd_cluster_size(int P, int C, int D) {
  if (!takes(P, C, D)) return -1;
  const cudaError_t err = opt_in_smem();
  return err == cudaSuccess ? cluster_size(P, C, D) : -static_cast<int>(err);
}

// Gamma shares a batch row (R: dgamma is [2, B * R]); -1 for a shape the
// kernel does not take.
extern "C" int dual_attention_bwd_shares(int P, int C, int D) {
  if (!takes(P, C, D)) return -1;
  return narrow(P, C, D) ? C / kRows : wide_shares(C);
}

// PAM ranks a batch row of a launch of B rows of the wide kernel (its
// clusters' size); -1 for a shape the kernel does not take.
extern "C" int dual_attention_bwd_pam_ranks(int B, int P, int C, int D) {
  if (!takes(P, C, D) || narrow(P, C, D)) return -1;
  return pam_ranks(P, B, 3 * fork2::sm_count() / 2);
}

// How many of a shape's CAM clusters the device can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int dual_attention_bwd_active_clusters(int P, int C, int D) {
  if (!takes(P, C, D)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return -static_cast<int>(err);
  const bool first = narrow(P, C, D);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(cfg, attr, cluster_size(P, C, D), 1,
            first ? smem_bytes(P, C, D) : cam_smem(C), nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n,
      first ? reinterpret_cast<const void*>(dual_attention_bwd_kernel)
            : (C > 256
                   ? reinterpret_cast<const void*>(dual_attention_bwd_wide_cam512)
                   : reinterpret_cast<const void*>(dual_attention_bwd_wide_cam)),
      &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
