// Mamba-2 decode step between the projections for Hopper (sm_90a), plain C
// interface for ctypes: K4.
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 layer.  It was
// added for Nemotron-H's decode step (models/mamba2.py), where no kernel
// of the port computes this, the plain form makes five passes over the
// state, and the plain step's ~70 small launches a layer left the decode
// loop paced by the host.  One call from the host launches three kernels
// on one stream, per batch row b (heads h of group g = h / (H / G), the
// conv over x, B and C, C_ = H P + 2 G N channels):
//   1. mamba2_conv_step_kernel: u = SiLU(conv_b + sum_j w_j ext_j) over the
//      taps ext = (the conv state's taps - 1 inputs, xbc), fp32, and the
//      conv state rolled by one; u = [x, B, C].
//   2. ssm_state_update_kernel (the mark the device trace finds):
//      dt = softplus(dt + dt_bias), A = -exp(A_log), and per head the
//      (P, N) state S, fp32, in place:
//        S <- exp(dt A) S + dt x (outer) B_g;  y = S C_g + D x
//   3. mamba2_gated_norm_kernel: out = RMSNorm over G groups of
//      y SiLU(z), times (1 + scale), in the activations' dtype.
//
// Bound.  The state update is the step: every state element is read once
// and written once, with four operations on it (the decay, the outer
// product's add, the read-out's multiply-add), 8 bytes against 4 flops.
// At Nemotron-H's decode shape (B=32, H=256, P=64, N=256) that is 1.074 GB
// a launch, 0.321 ms at the H100 SXM's 3.35 TB/s, against 0.54 GFLOP (8 us
// at 67 TFLOP/s fp32), so it is bound by bytes; u, dt and y add 3.4 MB.
// The conv step and the norm move ~6 MB between them.
//
// Design of the state update.  One CTA of NWARPS warps per (b, h) and
// block of ROWS state rows: B * H * P / ROWS CTAs (32768 at that shape),
// each independent.  A warp owns ROWS / NWARPS rows; its lanes split a
// row's N values in float4s (N / 128 float4s a lane), so a warp reads and
// writes 512 contiguous bytes at a time.  The warp loads all of its rows
// before it computes, so each lane has ROWS / NWARPS * N / 128 float4s
// (128 bytes at N = 256) in flight; with 16 CTAs resident per SM that is
// 256 KB an SM, far past the ~25 KB Little's law asks of each SM at 3.35
// TB/s and ~1 us of latency.  The state is read and written with
// streaming hints (__ldcs, __stcs): it is touched once a step and is 20x
// the L2.  Each lane keeps its group's B and C values in registers; a
// row's read-out is a warp's shuffle sum.  The state update is one fused
// multiply-add per element, so the result differs from the plain form's
// separate products in the last bits; the conv step's sums are taken in
// the plain form's order without contraction.
//
// The conv step runs one thread per (b, channel); the norm one CTA of 256
// threads per (b, group), two passes over the group's values (the second
// from L1/L2).  Activations (z, xbc, dt, the conv state, out) and weights
// (conv_w, conv_b, dt_bias, A_log, D, scale) are each fp32 or bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;               // warps per CTA of the state update
constexpr int NT = 32 * NWARPS;
constexpr int ROWS = 16;                // state rows per CTA
constexpr int RPW = ROWS / NWARPS;      // rows per warp
constexpr int TAPS = 4;                 // conv taps
constexpr int STATE = 256;              // N, the state size (Nemotron-H's)
constexpr int NV = STATE / 128;         // float4s of a state row per lane
constexpr int CONV_THREADS = 256;
constexpr int NORM_THREADS = 256;
static_assert(ROWS % NWARPS == 0, "whole rows per warp");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

template <typename A, typename W>
__global__ void __launch_bounds__(CONV_THREADS) mamba2_conv_step_kernel(
    A* __restrict__ cstate, const A* __restrict__ xbc, const W* __restrict__ w,
    const W* __restrict__ bias, float* __restrict__ u, int conv, long long xbc_stride) {
  const int c = blockIdx.x * CONV_THREADS + threadIdx.x;
  if (c >= conv) return;
  const long long b = blockIdx.y;
  A* s = cstate + (b * conv + c) * (TAPS - 1);
  const W* wc = w + (long long)c * TAPS;
  const A s0 = s[0], s1 = s[1], s2 = s[2];
  const A xn = xbc[b * xbc_stride + c];
  float acc = __fmul_rn(ld(&s0), ld(wc));
  acc = __fadd_rn(acc, __fmul_rn(ld(&s1), ld(wc + 1)));
  acc = __fadd_rn(acc, __fmul_rn(ld(&s2), ld(wc + 2)));
  acc = __fadd_rn(acc, __fmul_rn(ld(&xn), ld(wc + 3)));
  u[b * conv + c] = silu(__fadd_rn(acc, ld(bias + c)));
  s[0] = s1;
  s[1] = s2;
  s[2] = xn;
}

__device__ __forceinline__ float4 step4(float4 s, float decay, float u, float4 b) {
  return make_float4(fmaf(decay, s.x, u * b.x), fmaf(decay, s.y, u * b.y),
                     fmaf(decay, s.z, u * b.z), fmaf(decay, s.w, u * b.w));
}

__device__ __forceinline__ float dot4(float4 s, float4 c, float acc) {
  return fmaf(s.w, c.w, fmaf(s.z, c.z, fmaf(s.y, c.y, fmaf(s.x, c.x, acc))));
}

// u: (batch, conv) fp32, x at h * P, B at H * P + g * N, C at
// H * P + (G + g) * N.
template <typename A, typename W>
__global__ void __launch_bounds__(NT) ssm_state_update_kernel(
    float* __restrict__ state, const float* __restrict__ u, const A* __restrict__ dt,
    const W* __restrict__ dt_bias, const W* __restrict__ a_log, const W* __restrict__ D,
    float* __restrict__ y, int H, int G, int P, long long dt_stride) {
  constexpr int N = STATE;
  const int blocks_p = P / ROWS;
  const int h = blockIdx.x / blocks_p;
  const int p0 = (blockIdx.x % blocks_p) * ROWS;
  const long long b = blockIdx.y;
  const int g = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = b * H + h;
  const long long conv = (long long)H * P + 2LL * G * N;

  const float raw = __fadd_rn(ld(dt + b * dt_stride + h), ld(dt_bias + h));
  const float dtv = raw > 20.0f ? raw : log1pf(expf(raw));
  const float decay = expf(dtv * -expf(ld(a_log + h)));
  const float dv = ld(D + h);
  const float* ur = u + b * conv;
  const float4* b4 = reinterpret_cast<const float4*>(ur + (long long)H * P + (long long)g * N);
  const float4* c4 = reinterpret_cast<const float4*>(ur + (long long)H * P + (long long)(G + g) * N);
  const float* xr = ur + (long long)h * P;
  float4* s4 = reinterpret_cast<float4*>(state + bh * P * N);

  float4 s[RPW][NV];
  float xv[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int p = p0 + warp * RPW + r;
    xv[r] = xr[p];
#pragma unroll
    for (int i = 0; i < NV; ++i) s[r][i] = __ldcs(s4 + (long long)p * (N / 4) + lane + 32 * i);
  }
  float4 bv[NV], cv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    bv[i] = b4[lane + 32 * i];
    cv[i] = c4[lane + 32 * i];
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int p = p0 + warp * RPW + r;
    const float ux = dtv * xv[r];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      s[r][i] = step4(s[r][i], decay, ux, bv[i]);
      acc = dot4(s[r][i], cv[i], acc);
      __stcs(s4 + (long long)p * (N / 4) + lane + 32 * i, s[r][i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) y[bh * P + p] = fmaf(dv, xv[r], acc);
  }
}

// One CTA per (b, group) of gs values: out = h rsqrt(mean(h^2) + eps) (1 + scale),
// h = y SiLU(z).  y: (batch, G * gs) fp32; z rows z_stride apart; out (batch, G * gs).
template <typename A, typename W>
__global__ void __launch_bounds__(NORM_THREADS) mamba2_gated_norm_kernel(
    const float* __restrict__ y, const A* __restrict__ z, const W* __restrict__ scale,
    A* __restrict__ out, int gs, int G, long long z_stride, float eps) {
  __shared__ float part[NORM_THREADS / 32];
  const long long b = blockIdx.y;
  const int g = blockIdx.x;
  const long long off = (long long)g * gs;
  const float* yr = y + b * G * gs + off;
  const A* zr = z + b * z_stride + off;
  float ss = 0.f;
  for (int i = threadIdx.x; i < gs; i += NORM_THREADS) {
    const float hv = yr[i] * silu(ld(zr + i));
    ss = fmaf(hv, hv, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < NORM_THREADS / 32; ++k) total += part[k];
  const float r = rsqrtf(total / gs + eps);
  A* orow = out + b * G * gs + off;
  for (int i = threadIdx.x; i < gs; i += NORM_THREADS) {
    const float hv = yr[i] * silu(ld(zr + i));
    put(orow + i, hv * r * (1.0f + ld(scale + off + i)));
  }
}

template <typename A, typename W>
int launch(void* state, void* cstate, const void* z, const void* xbc, const void* dt,
           const void* conv_w, const void* conv_b, const void* dt_bias, const void* a_log,
           const void* D, const void* scale, float* u, float* y, void* out, int batch, int H,
           int G, int P, long long z_stride, long long xbc_stride, long long dt_stride,
           float eps, cudaStream_t s) {
  const int conv = H * P + 2 * STATE * G;
  const int gs = H * P / G;
  mamba2_conv_step_kernel<A, W><<<dim3((conv + CONV_THREADS - 1) / CONV_THREADS, batch),
                                   CONV_THREADS, 0, s>>>(
      static_cast<A*>(cstate), static_cast<const A*>(xbc), static_cast<const W*>(conv_w),
      static_cast<const W*>(conv_b), u, conv, xbc_stride);
  const dim3 grid((unsigned)(H * (P / ROWS)), (unsigned)batch);
  float* st = static_cast<float*>(state);
  const A* dtp = static_cast<const A*>(dt);
  const W* bp = static_cast<const W*>(dt_bias);
  const W* ap = static_cast<const W*>(a_log);
  const W* dp = static_cast<const W*>(D);
  ssm_state_update_kernel<A, W><<<grid, NT, 0, s>>>(st, u, dtp, bp, ap, dp, y, H, G, P,
                                                    dt_stride);
  mamba2_gated_norm_kernel<A, W><<<dim3(G, batch), NORM_THREADS, 0, s>>>(
      y, static_cast<const A*>(z), static_cast<const W*>(scale), static_cast<A*>(out), gs, G,
      z_stride, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// state: (batch, H, P, N) fp32 contiguous, updated in place; cstate:
// (batch, C_, 3) contiguous, rolled in place; z (batch, H P), xbc (batch,
// C_), dt (batch, H): rows z_stride, xbc_stride, dt_stride elements apart,
// each row contiguous; conv_w (C_, 4), conv_b (C_,), dt_bias, a_log, D
// (H,), scale (H P,) contiguous; u (batch, C_) and y (batch, H P) fp32
// scratch, out (batch, H P) contiguous.  cstate, z, xbc, dt and out are
// bf16 if act_bf16 else fp32; the weights bf16 if w_bf16 else fp32.  N is
// 256, P % 16 == 0, H % G == 0, taps 4, state and u 16-byte
// aligned.  Returns the cudaError_t of the launches (0 on success).
extern "C" int ssm_state_update_launch(void* state, void* cstate, const void* z, const void* xbc,
                                       const void* dt, const void* conv_w, const void* conv_b,
                                       const void* dt_bias, const void* a_log, const void* D,
                                       const void* scale, void* u, void* y, void* out,
                                       int act_bf16, int w_bf16, int batch, int H, int G, int P,
                                       int N, int taps, long long z_stride,
                                       long long xbc_stride, long long dt_stride, float eps,
                                       void* stream) {
  if (batch <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P % ROWS != 0 || taps != TAPS)
    return (int)cudaErrorInvalidValue;
  if (N != STATE) return (int)cudaErrorInvalidValue;
  if (batch > 65535 || (long long)H * (P / ROWS) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)state | (uintptr_t)u) % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* uf = static_cast<float*>(u);
  float* yf = static_cast<float*>(y);
#define K4_ARGS state, cstate, z, xbc, dt, conv_w, conv_b, dt_bias, a_log, D, scale, uf, yf, out, \
    batch, H, G, P, z_stride, xbc_stride, dt_stride, eps, s
  if (act_bf16 && w_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(K4_ARGS);
  if (act_bf16) return launch<__nv_bfloat16, float>(K4_ARGS);
  if (w_bf16) return launch<float, __nv_bfloat16>(K4_ARGS);
  return launch<float, float>(K4_ARGS);
#undef K4_ARGS
}
