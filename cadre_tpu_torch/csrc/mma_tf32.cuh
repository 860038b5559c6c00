// Shared by the dual-attention kernels: asynchronous copies into shared
// memory, and f32 products on the tensor cores in 3xTF32 (mma.sync
// m16n8k8, each operand split into a tf32 high part and the rest).
//
// 3xTF32: a = hi + lo, hi = a rounded to tf32 (cvt.rna's rounding, done
// with integer operations, which measured faster than cvt), lo = a - hi,
// exact in f32 and truncated to tf32 by the tensor cores; a tile
// accumulates lo hi + hi lo + hi hi in f32, within a few 1e-6 of each
// result's scale, as f32 FMA. Plain TF32 is not enough here: CAM's
// softmax reads rowmax(G) - G with |G| in the tens to hundreds, so a
// relative error of 1e-3 in G moves its attention by percents. Operands
// stay f32 in shared memory and are split as they are loaded into
// fragments. Ragged edges (M or N not a multiple of the tile, K not of 8)
// are clamped or masked in the loads, so no buffer is padded.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mma3 {

// ------------------------------------------------------- copies

// cp.async from global into shared memory; a group is committed by
// cp_commit and waited for by cp_wait<n> (at most n groups left in flight).
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns [c0, c0 + cols) of rows [0, rows) of a row-major array of T
// with row stride src_ld into shared memory with row stride ld, 16 bytes
// a copy (cols, c0, src_ld and ld in whole 16-byte units, src 16-byte
// aligned); by the block's `threads` threads. Where the threads divide a
// row's copies each thread keeps one column: one division a call, not one
// a copy.
template <typename T>
__device__ __forceinline__ void load_rows16(T* dst, int ld,
                                            const T* __restrict__ src,
                                            int rows, int cols, int src_ld,
                                            int c0, int threads) {
  constexpr int kPer = 16 / sizeof(T);
  const int c16 = cols / kPer;
  if (threads % c16 == 0) {
    const int step = threads / c16, c = (threadIdx.x % c16) * kPer;
    for (int r = threadIdx.x / c16; r < rows; r += step) {
      cp16(dst + r * ld + c, src + static_cast<size_t>(r) * src_ld + c0 + c);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * c16; i += threads) {
    const int r = i / c16, c = (i % c16) * kPer;
    cp16(dst + r * ld + c, src + static_cast<size_t>(r) * src_ld + c0 + c);
  }
}
// A [rows, cols] row-major f32 array, one word a copy.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int rows, int cols, int threads) {
  for (int i = threadIdx.x; i < rows * cols; i += threads) {
    cp4(dst + (i / cols) * ld + i % cols, src + i);
  }
}

// A row stride of at least n words, a multiple of 4 (16-byte rows) and
// 4 mod 8, so that the 8 x 4 lanes of a fragment load along rows hit
// distinct banks.
__host__ __device__ constexpr int ld4(int n) {
  return (n + 3) / 4 * 4 + ((n + 3) / 4 * 4 % 8 ? 0 : 4);
}
// A row stride of at least n words, 8 mod 32, so that the fragment loads
// across rows (element (i, k) at i + k * ld) hit distinct banks.
__host__ __device__ constexpr int ld8(int n) { return (n + 23) / 32 * 32 + 8; }

// ------------------------------------------------------- 3xTF32 tiles

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

}  // namespace mma3
