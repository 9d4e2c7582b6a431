// Sorted segment sum for Hopper (sm_90a), the deterministic mode's form of
// the segment sums of the flush (repro_torch/core/worp.py segment_sum).
//
// Stands in, under torch.use_deterministic_algorithms(True), for PyTorch's
// scatter_add_ there; the reference computes the same sums with
// jax.ops.segment_sum (src/repro/core/worp.py:70 in _dedup_topc, and
// src/repro/core/counters.py), in XLA, not in a pallas_call.  On the card
// PyTorch's deterministic scatter_add_ sorts its indices first: 7.97 ms at
// the flush's (4096, 5632) and 61.34 ms at the TV cascade's (32768, 5632),
// more than the device time of the flush it sits in; this kernel took
// 0.585 and 4.04 ms there (chip_smoke.py, H100 80GB HBM3, 700.00 W).
//
// Computes, for rows of n slots whose segment ids seg[r, i] count the runs
// of a stably sorted key row (nondecreasing from 0, steps of 0 or 1),
//   out[r, s] = sum of values[r, i] over the i with seg[r, i] == s
// and leaves out[r, s] as the caller zeroed it for s past the row's last
// run.  One thread per (row, slot); the thread at the head of a run adds
// the run's values in index order, from 0.0f, and writes one output: no
// two threads touch one output and the order is fixed, so every launch
// gives the same bits, and they are the bits of PyTorch's CPU scatter_add_,
// which adds in the same order.
//
// Bound: each slot's value (4 B) and segment id (8 B) read once and its
// output (4 B) written once, 16 B a slot: device-memory bytes, 0.110 ms at
// the flush shape (19 % of it reached).  Non-head threads read two ids and
// return; a head reads its run serially, so a Zipf head of ~1000 slots is
// one thread's loop (a few microseconds), and the dense refresh's runs of
// padding keys (tens of millions of slots, all summing zeros) are slow:
// that path keeps scatter_add_ when the mode is off, as it is by default.
#include <cstdint>

#include <cuda_runtime.h>

#include "kernel_info.cuh"

namespace {

__global__ void segment_sum_kernel(const float* __restrict__ values,
                                   const int64_t* __restrict__ seg,
                                   float* __restrict__ out, int64_t rows,
                                   int64_t n) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  const int64_t r = idx / n;
  const int64_t i = idx - r * n;
  const int64_t* srow = seg + r * n;
  const int64_t s = srow[i];
  if ((i > 0 && srow[i - 1] == s) || s < 0 || s >= n) return;
  const float* vrow = values + r * n;
  float sum = 0.0f;
  for (int64_t j = i; j < n && srow[j] == s; ++j) {
    sum = __fadd_rn(sum, vrow[j]);
  }
  out[r * n + s] = sum;
}

}  // namespace

// `blocks` x `threads` threads cover rows * n slots; `out` is zeroed by
// the caller.  Launches on `stream`; returns a CUDA error code (0 on
// success).
extern "C" int worp_segment_sum(const void* values, const void* seg,
                                void* out, int64_t rows, int64_t n,
                                int blocks, int threads, void* stream) {
  segment_sum_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int64_t*>(seg),
      static_cast<float*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory, blocks per SM and dynamic shared memory
// (worp::kernel_info); the kernel has one variant (0).
extern "C" int worp_segment_sum_info(int variant, int threads,
                                     int smem_bytes, int* out) {
  (void)variant;
  return worp::kernel_info(segment_sum_kernel, threads, smem_bytes, out);
}
