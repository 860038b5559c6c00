// Shared by the dual-attention kernels: the device's SM count, and a
// second launch that runs beside the first. Its stream is the calling
// thread's own for the device, forked from the caller's stream by an
// event after the caller's work so far and joined back by another before
// the caller's next (a fork and join that CUDA graph capture records as
// such), so that the two launches' partial last waves and latency-bound
// phases overlap. Made once per host thread and device, at its first use:
// two threads never share an event, so one thread's fork cannot bind to
// another's record.
#pragma once

#include <cuda_runtime.h>

namespace fork2 {

// The current device's SM count (1 if it cannot be read), read once.
inline int sm_count() {
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

struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

// This thread's side stream and events on the current device.
inline cudaError_t side(Side** out) {
  static thread_local Side sides[64];
  static thread_local unsigned long long made = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  Side& sd = sides[dev & 63];
  if (!(made & bit)) {
    err = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    }
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    }
    if (err != cudaSuccess) return err;
    made |= bit;
  }
  *out = &sd;
  return cudaSuccess;
}

// The side stream, which waits for everything issued on `st` so far.
inline cudaError_t fork(cudaStream_t st, Side** sd) {
  cudaError_t err = side(sd);
  if (err == cudaSuccess) err = cudaEventRecord((*sd)->fork, st);
  if (err == cudaSuccess) err = cudaStreamWaitEvent((*sd)->stream, (*sd)->fork, 0);
  return err;
}

// `st` waits for everything issued on the side stream so far.
inline cudaError_t join(cudaStream_t st, Side* sd) {
  cudaError_t err = cudaEventRecord(sd->join, sd->stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(st, sd->join, 0);
  return err;
}

}  // namespace fork2
