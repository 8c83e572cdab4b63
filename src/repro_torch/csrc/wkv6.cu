// RWKV-6 WKV recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/wkv6.py::_wkv6_kernel (grid
// (B*H, 1, T/block_t) with the (dh, dh) fp32 state in VMEM scratch across
// the sequential time axis).  Per (batch b, head h), over t:
//   y_t[e]   = sum_d r_t[d] * (S[d,e] + u[d] * k_t[d] * v_t[e])
//   S[d,e]  <- exp(logw_t[d]) * S[d,e] + k_t[d] * v_t[e]
// starting from s0 (or zeros), and the final state is written out: the
// serving path keeps it as the decode cache (the Pallas kernel kept it in
// s_scr and dropped it).
//
// Design.  One CTA of 256 threads per (b, h), with the time loop inside the
// CTA: CTAs run in no order, so nothing can carry across them (the TPU
// kernel carried S across its "arbitrary" grid axis instead).  Thread
// (q, e) owns column e of the state for the rows d in [q*DPT, (q+1)*DPT):
// DPT = DH*DH/256 fp32 registers (16 at dh = 64), so the state never leaves
// registers and the update needs no communication.  Each block of BT time
// steps is staged through shared memory (r, k, v, exp(logw) in fp32,
// coalesced along dh); a warp's threads share q, so their reads of r/k/w
// rows are broadcasts.  The y of a step is a sum over d, split across the
// 256/DH row groups: each thread leaves its partial sum in shared memory
// and, after the block, the CTA adds the partials and writes y.  Inputs are
// taken as (B, T, H, dh) by strides, so heads are never merged by a copy.
//
// Bound.  At the serving prefill shape (B=4, T=2048, H=40, dh=64; r/k/v
// bf16, logw fp32) the function does 5*dh^2 fp32 flops per (b, h, t)
// (the y product 2*dh^2, the k v^T outer product dh^2, the decayed update
// 2*dh^2): 6.7 GFLOP, 0.10 ms at the H100 SXM's 67 TFLOP/s fp32 (no tensor
// cores: each step is a rank-1 update).  Its bytes, 0.25 GB, take 0.075 ms
// at 3.35 TB/s, so it is bound by operations.  This first version has
// B*H = 160 CTAs of 8 warps for 132 SMs and a dependent chain of DPT
// fused multiply-adds per step in each thread; the chunked matmul form
// (tensor cores within a chunk, the state across chunks) is the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int BT = 16;   // time steps staged per block

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;    // (H, dh) fp32
  const float* s0;   // (B, H, dh, dh) fp32 or null
  void* y;
  float* s_out;      // (B, H, dh, dh) fp32
  int H, T;
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long y_sb, y_st, y_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) wkv6_fwd(const Params p) {
  constexpr int Q = NT / DH;    // row groups
  constexpr int DPT = DH / Q;   // state rows per thread
  static_assert(DPT % 4 == 0, "rows per thread must be a multiple of 4");
  __shared__ __align__(16) float rs[BT][DH];
  __shared__ __align__(16) float ks[BT][DH];
  __shared__ __align__(16) float ws[BT][DH];
  __shared__ float vs[BT][DH];
  __shared__ float yp[BT][Q][DH];

  const int e = threadIdx.x % DH;
  const int q = threadIdx.x / DH;
  const int d0 = q * DPT;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;

  const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wg = p.logw + b * p.w_sb + h * p.w_sh;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long state = (long long)blockIdx.x * DH * DH;

  float S[DPT], uq[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    S[j] = p.s0 ? p.s0[state + (long long)(d0 + j) * DH + e] : 0.f;
    uq[j] = p.u[h * DH + d0 + j];
  }

  for (int t0 = 0; t0 < p.T; t0 += BT) {
    const int n = min(BT, p.T - t0);
    for (int idx = threadIdx.x; idx < n * DH; idx += NT) {
      const int i = idx / DH, c = idx % DH;
      const long long t = t0 + i;
      rs[i][c] = to_f32(rg[t * p.r_st + c]);
      ks[i][c] = to_f32(kg[t * p.k_st + c]);
      vs[i][c] = to_f32(vg[t * p.v_st + c]);
      ws[i][c] = expf(wg[t * p.w_st + c]);
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      const float ve = vs[i][e];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < DPT; j += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[i][d0 + j]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[i][d0 + j]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[i][d0 + j]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk[c] * ve;
          acc = fmaf(rr[c], fmaf(uq[j + c], kv, S[j + c]), acc);
          S[j + c] = fmaf(ww[c], S[j + c], kv);
        }
      }
      yp[i][q][e] = acc;
    }
    __syncthreads();  // partials complete; staging buffers free

    for (int idx = threadIdx.x; idx < n * DH; idx += NT) {
      const int i = idx / DH, c = idx % DH;
      float y = 0.f;
#pragma unroll
      for (int g = 0; g < Q; ++g) y += yp[i][g][c];
      yg[(long long)(t0 + i) * p.y_st + c] = from_f32<T>(y);
    }
    // the next block's staging touches only rs/ks/vs/ws, and its partials
    // are written after the next __syncthreads, when every sum here is done
  }

#pragma unroll
  for (int j = 0; j < DPT; ++j)
    p.s_out[state + (long long)(d0 + j) * DH + e] = S[j];
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  wkv6_fwd<T, DH><<<B * p.H, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const Params& p, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y: (B, T, H, dh) of one dtype (is_bf16 selects __nv_bfloat16,
// else float); logw: (B, T, H, dh) fp32; strides in elements, the last
// dimension contiguous.  u: (H, dh) fp32 contiguous; s0 (may be null) and
// s_out: (B, H, dh, dh) fp32 contiguous.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int wkv6_fwd_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* s0, void* y, void* s_out, int is_bf16,
    int B, int T, int H, int dh,
    long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long w_sb, long long w_st, long long w_sh,
    long long y_sb, long long y_st, long long y_sh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(logw), static_cast<const float*>(u),
           static_cast<const float*>(s0), y, static_cast<float*>(s_out), H, T,
           r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           w_sb, w_st, w_sh, y_sb, y_st, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_dh<__nv_bfloat16>(p, B, dh, st)
                       : dispatch_dh<float>(p, B, dh, st));
}
