// RG-LRU linear recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::_rglru_kernel (grid
// (batch tiles, width tiles, time blocks) with the (block_b, block_w)
// carry in VMEM scratch across the sequential time axis):
//   h_t = a_t * h_{t-1} + b_t     per channel, fp32, from h0 (or zeros).
//
// Design.  One thread per (batch, channel): the carry stays in a register
// and the time loop runs inside the thread, so nothing has to carry across
// CTAs (which run in no order).  Neighbouring threads own neighbouring
// channels, so every load and store of a step is coalesced along W.  The
// time loop is software-pipelined: the a and b of the next U steps are
// loaded while the current U steps' multiply-adds run, so each thread
// keeps 2U loads in flight behind its dependent chain.  CTAs are 64 threads,
// so the B*W channels of the serving shape (8192) spread over 128 SMs.
//
// Bound.  Two reads and one write of (B, S, W) fp32 and one multiply-add
// per element: at the serving prefill shape (B=2, S=4096, W=4096) 0.40 GB,
// 0.12 ms at the H100 SXM's 3.35 TB/s, against 0.07 GFLOP, so it is bound
// by bytes.  With one thread per channel the loads in flight are what
// limits it: 8192 threads x 2U loads of 4 bytes.  Splitting time into
// chunks scanned in parallel (a second pass carries the chunk states) is
// the next step if that is too few.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 64;  // threads per CTA
constexpr int U = 16;   // steps loaded ahead

// a * h + b rounded after the product and after the sum, as the reference
// computes it (no contraction into one fused multiply-add)
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__global__ void __launch_bounds__(NT) rglru_scan_fwd(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ h,
    int B, int S, int W) {
  const long long ch = (long long)blockIdx.x * NT + threadIdx.x;
  if (ch >= (long long)B * W) return;
  const long long bi = ch / W, w = ch % W;
  const long long base = bi * S * W + w;
  float hv = h0 ? h0[bi * W + w] : 0.f;

  const int full = S - S % U;
  float an[U], bn[U];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      an[i] = a[base + (long long)i * W];
      bn[i] = b[base + (long long)i * W];
    }
  }
  for (int t = 0; t < full; t += U) {
    float ac[U], bc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      ac[i] = an[i];
      bc[i] = bn[i];
    }
    if (t + U < full) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        an[i] = a[base + (long long)(t + U + i) * W];
        bn[i] = b[base + (long long)(t + U + i) * W];
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      hv = step(ac[i], hv, bc[i]);
      h[base + (long long)(t + i) * W] = hv;
    }
  }
  for (int t = full; t < S; ++t) {
    hv = step(a[base + (long long)t * W], hv, b[base + (long long)t * W]);
    h[base + (long long)t * W] = hv;
  }
}

}  // namespace

// a, b, h: (B, S, W) fp32 contiguous; h0: (B, W) fp32 contiguous or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_scan_fwd_launch(const void* a, const void* b, const void* h0,
                                     void* h, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long channels = (long long)B * W;
  const unsigned grid = (unsigned)((channels + NT - 1) / NT);
  rglru_scan_fwd<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), B, S, W);
  return (int)cudaGetLastError();
}
