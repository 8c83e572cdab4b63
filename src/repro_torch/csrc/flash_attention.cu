// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (with the GQA head expansion of repro/kernels/ops.py::attention folded
// in): softmax(scale * q k^T, causal / sliding-window masked, optional tanh
// softcap) v, with an fp32 online softmax (running max, denominator and
// accumulator), p rounded to v's type before the PV product, and rows whose
// every key is masked giving 0.
//
// Serves fp32 at every head size and bf16 at d_head 16 and 32 only: bf16
// at d_head 64, 128 and 256, the serving path's shapes, goes to the
// tensor-core kernel csrc/flash_attention_sm90.cu (the wrapper's variant()
// chooses by dtype and head size).
//
// Design.  One CTA of 128 threads per (batch*head, BQ-row q tile); the loop
// over 64-key KV tiles runs inside the CTA, because CTAs run in no order
// and nothing carries across them (the TPU kernel carried the running state
// across its sequential "arbitrary" grid axis instead).  The q tile is held
// scaled in fp32 in shared memory; K and then V of each tile are staged
// through one shared buffer.  Thread (ty, tx) owns query rows ty + 8i
// (i < BQ/8): its (BQ/8)x4 block of scores, the rows' running max and
// denominator, and the BQ/8 x dh/16 block of the output accumulator, so the
// softmax needs only shuffles among the 16 lanes that share a row.  BQ is
// 64, and 32 at dh = 256: there a 64-row tile would hold 8 x 16 = 128 fp32
// accumulators per thread before the scores (spills) and ~150 KB of shared
// memory; 32 rows halve both.  The KV head of query
// head h is h / (H / KH) (GQA without copies: the wrapper passes strides).
// KV tiles wholly above the diagonal or wholly outside the window are not
// visited; ragged tails are masked, so any length works.
//
// Bound.  Operations: 4*B*H*dh per visible (q, k) pair.  The kernel
// computes on the fp32 SIMT pipes (67 TFLOP/s peak), with 16-byte
// shared-memory loads that give each thread 32 independent FMAs per load
// group, so it is held to the fp32 peak: exact enough for fp32 at 1e-5,
// which bf16 tensor cores cannot meet.  (At yi-34b's bf16 prefill shape it
// took 11.8 ms against a 0.24 ms tensor-core bound, which is why that shape
// now runs on csrc/flash_attention_sm90.cu.)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 128;       // threads per CTA: 8 row groups x 16 lanes
constexpr int KPT = BK / 16;  // keys per thread in the score block

// query rows per CTA for head size DH
template <int DH> struct QRows { static constexpr int value = DH >= 256 ? 32 : 64; };
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KH, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale, softcap;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows [r0, r0 + rows) of a (S, dh) slice with row stride `ss` into
// shared memory as fp32 (row stride LD), zero past `S`, times `mul`.
template <typename T, int DH, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int rows, int S, float mul) {
  for (int e = threadIdx.x; e < rows * DH; e += NT) {
    const int r = e / DH, c = e % DH;
    const int s = r0 + r;
    dst[r * LD + c] = s < S ? to_f32(src[(long long)s * ss + c]) * mul : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd(const Params p) {
  constexpr int LD = DH + 4;   // fp32 row stride of the q / kv tiles (16 B aligned)
  constexpr int LP = BK + 4;   // fp32 row stride of the p tile
  constexpr int CPT = DH / 16; // output columns per thread
  constexpr int BQ = QRows<DH>::value;
  constexpr int RPT = BQ / 8;  // query rows per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * BQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // q in fp32 times scale, as the TPU kernel's q.astype(f32) * scale
  stage<T, DH, LD>(Qs, qg, p.q_ss, q0, BQ, p.Sq, p.scale);

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // keys this q tile can see: [kv_lo, kv_hi)
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q0 + BQ);
  const int kv_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = kv_lo / BK;
  const int t_hi = (kv_hi + BK - 1) / BK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's PV is done with KVs and Ps
    stage<T, DH, LD>(KVs, kg, p.k_ss, k0, BK, p.Sk, 1.f);
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 8 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // softcap, mask, online softmax; p rounded to T before it meets v
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kp < p.Sk;
        if (p.causal) ok = ok && qp >= kp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        // guard: a masked key gives p == 0, also where the row max is masked
        const float pv = s[i][j] <= NEG_INF / 2 ? 0.f : expf(s[i][j] - m_new);
        rs += pv;
        Ps[(ty + 8 * i) * LP + tx + 16 * j] = to_f32(from_f32<T>(pv));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with K; Ps is complete
    stage<T, DH, LD>(KVs, vg, p.v_ss, k0, BK, p.Sk, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 8 * i) * LP + kk]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v0 = KVs[(kk + 0) * LD + tx + 16 * c];
        const float v1 = KVs[(kk + 1) * LD + tx + 16 * c];
        const float v2 = KVs[(kk + 2) * LD + tx + 16 * c];
        const float v3 = KVs[(kk + 3) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + 8 * i;
    if (qp >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      og[(long long)qp * p.o_ss + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = DH + 4;
  constexpr int BQ = QRows<DH>::value;
  const int smem = (BQ * LD + BK * LD + BQ * (BK + 4)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd<T, DH><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Sq, H, dh); k, v: (B, Sk, KH, dh); strides in elements, the
// last dimension contiguous.  is_bf16 selects __nv_bfloat16 (else float).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int B, int H, int KH, int Sq, int Sk, int dh,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, float softcap, void* stream) {
  if (KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  if (Sq <= 0 || Sk <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, B, H, KH, Sq, Sk,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_dh<__nv_bfloat16>(p, dh, st)
                       : dispatch_dh<float>(p, dh, st));
}
