// Fused position (PAM) and channel (CAM) attention of the DANet head, one
// block per batch row.
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
// in f32 and rounded once, as the TPU kernel does.
//
// What bounds it on an H100: at the main path's shapes (P = 40, C = 128,
// D = 16) a row moves about 54 KB in bf16 and does about 3.1 MFLOP, so the
// function is bound by bytes: about 0.5 us at B = 32 and 4 us at B = 256.
// At B = 32 only 32 blocks run, so launch and latency dominate.
//
// Design: everything a row needs lives in shared memory as f32 (q, k, v,
// the CAM input, the [P, P] energy and the [C, C] gram, about 116 KB at the
// main path's shapes, hence the opt-in above 48 KB). The row is read from
// device memory once and both outputs are written once. Each softmax row is
// reduced by one warp with shuffles. The gram is stored with a row stride of
// C + 1 and k with D + 1, so the column walks of the apply loops hit
// distinct banks. The key loops run over exactly P positions, so there is
// no padding to mask. Tensor cores are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In-place softmax of one row by one warp; with `cam` the row is first
// replaced by rowmax(row) - row. The result is rounded to T.
template <typename T>
__device__ void softmax_row(float* row, int n, int lane, bool cam) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  if (cam) {
    float m2 = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float t = m - row[j];
      row[j] = t;
      m2 = fmaxf(m2, t);
    }
    m = warp_max(m2);
  }
  float s = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(row[j] - m);
    row[j] = e;
    s += e;
  }
  s = warp_sum(s);
  for (int j = lane; j < n; j += 32) row[j] = round_to<T>(row[j] / s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dual_attention_kernel(const T* __restrict__ xp, const T* __restrict__ q,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ gp, const T* __restrict__ xc,
                      const float* __restrict__ gc, T* __restrict__ outp,
                      T* __restrict__ outc, int P, int C, int D) {
  extern __shared__ float sm[];
  float* qs = sm;                       // [P, D]
  float* ks = qs + P * D;               // [P, D + 1]
  float* att = ks + P * (D + 1);        // [P, P]
  float* vs = att + P * P;              // [P, C]
  float* xs = vs + P * C;               // [P, C]
  float* gram = xs + P * C;             // [C, C + 1]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t oq = static_cast<size_t>(blockIdx.x) * P * D;
  const size_t ov = static_cast<size_t>(blockIdx.x) * P * C;

  for (int i = tid; i < P * D; i += nt) {
    qs[i] = to_f32(q[oq + i]);
    ks[(i / D) * (D + 1) + i % D] = to_f32(k[oq + i]);
  }
  for (int i = tid; i < P * C; i += nt) {
    vs[i] = to_f32(v[ov + i]);
    xs[i] = to_f32(xc[ov + i]);
  }
  __syncthreads();

  // PAM energy [P, P] and CAM gram [C, C]
  for (int i = tid; i < P * P; i += nt) {
    const int r = i / P, c = i % P;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += qs[r * D + d] * ks[c * (D + 1) + d];
    att[i] = acc;
  }
  for (int i = tid; i < C * C; i += nt) {
    const int r = i / C, c = i % C;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += xs[p * C + r] * xs[p * C + c];
    gram[r * (C + 1) + c] = acc;
  }
  __syncthreads();

  for (int r = warp; r < P; r += nwarps) softmax_row<T>(att + r * P, P, lane, false);
  for (int r = warp; r < C; r += nwarps)
    softmax_row<T>(gram + r * (C + 1), C, lane, true);
  __syncthreads();

  const float g_pam = gp[0];
  const float g_cam = gc[0];
  for (int i = tid; i < P * C; i += nt) {
    const int r = i / C, c = i % C;
    float acc_p = 0.f;
    for (int j = 0; j < P; ++j) acc_p += att[r * P + j] * vs[j * C + c];
    outp[ov + i] = from_f32<T>(g_pam * acc_p + to_f32(xp[ov + i]));
    float acc_c = 0.f;
    for (int j = 0; j < C; ++j) acc_c += gram[c * (C + 1) + j] * xs[r * C + j];
    outc[ov + i] = from_f32<T>(g_cam * acc_c + xs[i]);
  }
}

template <typename T>
int launch(const void* xp, const void* q, const void* k, const void* v,
           const void* gp, const void* xc, const void* gc, void* outp,
           void* outc, int B, int P, int C, int D, void* stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(P) * D + P * (D + 1) + P * P + 2 * P * C +
       C * (C + 1));
  cudaError_t err = cudaFuncSetAttribute(
      dual_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dual_attention_kernel<T><<<B, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(gp), static_cast<const T*>(xc),
      static_cast<const float*>(gc), static_cast<T*>(outp),
      static_cast<T*>(outc), P, C, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_pam, v, x_cam, out_pam, out_cam: [B, P, C]; q, k: [B, P, D]; all
// contiguous and of one type. gamma_pam, gamma_cam: [1] f32 on the device.
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
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
  return launch<__nv_bfloat16>(xp, q, k, v, gp, xc, gc, outp, outc, B, P, C,
                               D, stream);
}
