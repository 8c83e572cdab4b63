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
// Bound.  At the serving prefill shape (B=4, T=2048, H=40, dh=64; r/k/v
// bf16, logw fp32) the function does 5*dh^2 fp32 flops per (b, h, t)
// (the y product 2*dh^2, the k v^T outer product dh^2, the decayed update
// 2*dh^2): 6.71 GFLOP, 0.100 ms at the H100 SXM's 67 TFLOP/s fp32 (no
// tensor cores: each step is a rank-1 update with a data-dependent
// diagonal decay, no matrix product).  Its bytes, 0.254 GB, take 0.076 ms
// at 3.35 TB/s, so it is bound by operations.  Per state element and step
// the exact recurrence issues 4 fp32 instructions (kv, two fmas for y, one
// for S), so an issue-bound kernel needs about 0.18 ms at ~1.75 GHz.
//
// Design.  CTAs run in no order, so the time loop stays inside each CTA
// (the TPU kernel carried S across its "arbitrary" grid axis instead).
// What the first version (one CTA of 256 threads per (b, h), every thread
// loading, computing and summing) lost time to, and what this one does:
//  1. Wave quantization: 160 CTAs on 132 SMs left 28 SMs with two.  Column
//     e of S and y_t[e] need all of r, k, w and u but only v[:, e], so a
//     CTA owns EV = 16 value columns of one (b, h): grid B*H*dh/EV, the
//     column blocks of a head adjacent so that their re-reads of r, k and
//     logw come from L2.  At the serving shape that is 640 CTAs, 4.85 per
//     SM, all resident at once (5 per SM fit by shared memory and
//     registers): the makespan is within 3 % of the mean.
//  2. Synchronous staging: each block of steps waited on its own global
//     loads.  Now a producer warp copies blocks of BT = 8 steps of r, k,
//     logw (all dh) and v (the CTA's EV columns) by cp.async into a ring of
//     NR raw stages, NR - 1 blocks ahead of the block being run, widens
//     them (bf16 -> fp32, logw -> expf) into a double-buffered fp32 block
//     once its own copies have landed (each lane widens the 16-byte chunks
//     it copied, after cp.async.wait_group), and sums y.  Two consumer
//     warps only run the recurrence.  One barrier per block publishes the
//     next block, frees a stage and hands over the partial sums of y; no
//     barrier waits per step.
//  3. Few FMAs per shared-memory read: consumer thread (g, c) owns RPT rows
//     x CPT = 4 columns of the CTA's slice (4 x 4 at dh = 64), so per step
//     it reads four vectors (r, k, w rows; v columns) for 16 state
//     elements.  The y of a step is summed over the thread's rows in CPT
//     independent accumulators and stored as one partial per row group; the
//     producer adds a block's partials in row-group order and writes y
//     during the next block.
// Each state element's arithmetic is the first version's (kv = k*v;
// acc = fmaf(r, fmaf(u, kv, S), acc); S = fmaf(w, S, kv), w = expf(logw)),
// so s_final is the same bit for bit; only y's order of summation over d
// changes.  Inputs are taken as (B, T, H, dh) by strides, so heads are
// never merged by a copy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

namespace {

constexpr int NC = 64;           // consumer threads: the recurrence
constexpr int NP = 32;           // producer threads (one warp): staging, y
constexpr int NT = NC + NP;      // threads per CTA
constexpr int EV = 16;           // value columns per CTA
constexpr int CPT = 4;           // value columns per consumer thread
constexpr int CG = EV / CPT;     // column groups
constexpr int RG = NC / CG;      // row groups
constexpr int BT = 8;            // time steps per staged block
constexpr int YROW = RG * EV + 16;   // floats per step of partial sums; the
                                     // pad puts odd steps on the other banks

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

template <typename T, int DH>
struct Smem {
  static constexpr int NR = sizeof(T) == 2 ? 3 : 2;   // raw stages
  // raw copies keep T's bits (bf16 as unsigned short: no constructor runs)
  using E = typename std::conditional<sizeof(T) == 2, unsigned short, float>::type;
  struct __align__(16) Raw { E r[BT][DH]; E k[BT][DH]; float w[BT][DH]; E v[BT][EV]; };
  struct __align__(16) Blk { float r[BT][DH]; float k[BT][DH]; float w[BT][DH]; float v[BT][EV]; };
  Raw raw[NR];
  Blk blk[2];
  float yp[2][BT][YROW];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// One barrier for producer and consumers, reached from their own code.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// 16 bytes of T in shared memory, widened to fp32 at dst.
__device__ __forceinline__ void widen16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void widen16(float* dst, const unsigned short* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  float f[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {       // exact: a bf16 is the high half of its fp32
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// N = 2 or 4 consecutive floats, read or written as one vector.
template <int N> __device__ __forceinline__ void load_n(float (&x)[N], const float* p) {
  static_assert(N == 2 || N == 4, "2 or 4 floats");
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}
template <int N> __device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 floats");
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

__device__ __forceinline__ void store4(float* dst, float4 y) {
  *reinterpret_cast<float4*>(dst) = y;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 y) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) wkv6_fwd(const Params p) {
  using Sm = Smem<T, DH>;
  constexpr int NR = Sm::NR;
  constexpr int RPT = DH / RG;                  // state rows per consumer thread
  constexpr int NCB = DH / EV;                  // column blocks per head
  constexpr int EPC = 16 / sizeof(T);           // elements per 16-byte chunk
  constexpr int CR = DH / EPC;                  // chunks per r or k row
  constexpr int CW = DH / 4;                    // chunks per logw row
  constexpr int CV = EV / EPC;                  // chunks per v row
  static_assert(DH % EV == 0 && RPT * RG == DH, "dh must be a multiple of 16");
  __shared__ Sm sm;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / NCB;
  const int e0 = (blockIdx.x % NCB) * EV;
  const int b = bh / p.H, h = bh % p.H;
  const int nb = (p.T + BT - 1) / BT;

  if (tid >= NC) {
    // Producer warp: copies, widening and the sums of y.  Lane l's 16-byte
    // chunks of a block: chunk m of an array with C chunks per row is
    // c = l + m*NP, at row c / C and column (c % C) * E, the same in every
    // block, so their sources are computed once and moved by whole blocks;
    // copies and widening take the same chunks, so the lane widens exactly
    // what it copied once its own copies have landed.
    const int lane = tid - NC;
    constexpr int MR = (BT * CR + NP - 1) / NP;   // chunks per lane: r and k
    constexpr int MW = (BT * CW + NP - 1) / NP;   // logw
    constexpr int MV = (BT * CV + NP - 1) / NP;   // v
    const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
    const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + e0;
    const float* wg = p.logw + b * p.w_sb + h * p.w_sh;
    const T* r_src[MR];
    const T* k_src[MR];
    const float* w_src[MW];
    const T* v_src[MV];
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int c = lane + m * NP, i = c / CR, j = (c % CR) * EPC;
      r_src[m] = rg + i * p.r_st + j;
      k_src[m] = kg + i * p.k_st + j;
    }
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int c = lane + m * NP, i = c / CW, j = (c % CW) * 4;
      w_src[m] = wg + i * p.w_st + j;
    }
#pragma unroll
    for (int m = 0; m < MV; ++m) {
      const int c = lane + m * NP, i = c / CV, j = (c % CV) * EPC;
      v_src[m] = vg + i * p.v_st + j;
    }

    auto issue = [&](int blk) {
      auto& st = sm.raw[blk % NR];
      const int n = min(BT, p.T - blk * BT);
      const long long t0 = (long long)blk * BT;
      const long long ro = t0 * p.r_st, ko = t0 * p.k_st, wo = t0 * p.w_st, vo = t0 * p.v_st;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int c = lane + m * NP, i = c / CR, j = (c % CR) * EPC;
        if (c < BT * CR && i < n) {
          cp_async16(&st.r[i][j], r_src[m] + ro);
          cp_async16(&st.k[i][j], k_src[m] + ko);
        }
      }
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int c = lane + m * NP, i = c / CW, j = (c % CW) * 4;
        if (c < BT * CW && i < n) cp_async16(&st.w[i][j], w_src[m] + wo);
      }
#pragma unroll
      for (int m = 0; m < MV; ++m) {
        const int c = lane + m * NP, i = c / CV, j = (c % CV) * EPC;
        if (c < BT * CV && i < n) cp_async16(&st.v[i][j], v_src[m] + vo);
      }
    };
    auto widen = [&](int blk) {
      const auto& st = sm.raw[blk % NR];
      auto& o = sm.blk[blk & 1];
      const int n = min(BT, p.T - blk * BT);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int c = lane + m * NP, i = c / CR, j = (c % CR) * EPC;
        if (c < BT * CR && i < n) {
          widen16(&o.r[i][j], &st.r[i][j]);
          widen16(&o.k[i][j], &st.k[i][j]);
        }
      }
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int c = lane + m * NP, i = c / CW, j = (c % CW) * 4;
        if (c < BT * CW && i < n) {
          const float4 lw = *reinterpret_cast<const float4*>(&st.w[i][j]);
          store4(&o.w[i][j], make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w)));
        }
      }
#pragma unroll
      for (int m = 0; m < MV; ++m) {
        const int c = lane + m * NP, i = c / CV, j = (c % CV) * EPC;
        if (c < BT * CV && i < n) widen16(&o.v[i][j], &st.v[i][j]);
      }
    };
    // y of one block: lane l sums step l / (EV/4), columns 4 (l % (EV/4))
    // over the row groups' partials, in row-group order.
    static_assert(BT * EV / 4 == NP, "one (step, 4 columns) sum of y per producer lane");
    const int yi = lane / (EV / 4), yc = (lane % (EV / 4)) * 4;
    T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + e0 + yc;
    auto flush = [&](int blk) {
      if (yi >= p.T - blk * BT) return;
      const float* sums = &sm.yp[blk & 1][yi][yc];
      float4 y = *reinterpret_cast<const float4*>(sums);
#pragma unroll
      for (int q = 1; q < RG; ++q) {
        const float4 z = *reinterpret_cast<const float4*>(sums + q * EV);
        y.x += z.x; y.y += z.y; y.z += z.z; y.w += z.w;
      }
      store4(yg + ((long long)blk * BT + yi) * p.y_st, y);
    };

#pragma unroll
    for (int s = 0; s < NR - 1; ++s) {
      if (s < nb) issue(s);
      cp_async_commit();
    }
    cp_async_wait<NR - 2>();
    widen(0);
    for (int blk = 0; blk < nb; ++blk) {
      // block blk widened and published; blk - 1's partials complete; the
      // raw stage of blk - 1 and the buffers of blk + 1 free
      block_sync();
      if (blk + NR - 1 < nb) issue(blk + NR - 1);
      cp_async_commit();            // empty groups keep the wait count uniform
      if (blk > 0) flush(blk - 1);
      if (blk + 1 < nb) {
        cp_async_wait<NR - 2>();    // this lane's copies of blk + 1 landed
        widen(blk + 1);
      }
    }
    block_sync();
    flush(nb - 1);
    return;
  }

  // Consumer threads: the recurrence, on thread (g, c)'s RPT x CPT tile of
  // the state.
  const int g = tid / CG;
  const int d0 = g * RPT, c0 = (tid % CG) * CPT;
  const long long state = (long long)bh * DH * DH + e0 + c0;
  float S[RPT][CPT], uq[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    uq[j] = p.u[h * DH + d0 + j];
#pragma unroll
    for (int c = 0; c < CPT; ++c) S[j][c] = 0.f;
    if (p.s0) load_n(S[j], p.s0 + state + (long long)(d0 + j) * DH);
  }

  for (int blk = 0; blk < nb; ++blk) {
    block_sync();
    const auto& o = sm.blk[blk & 1];
    float (*yp)[YROW] = sm.yp[blk & 1];
    auto step = [&](int i) {
      float rr[RPT], kk[RPT], ww[RPT], vv[CPT];
      load_n(rr, &o.r[i][d0]);
      load_n(kk, &o.k[i][d0]);
      load_n(ww, &o.w[i][d0]);
      load_n(vv, &o.v[i][c0]);
      float acc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float kv = kk[j] * vv[c];
          acc[c] = fmaf(rr[j], fmaf(uq[j], kv, S[j][c]), acc[c]);
          S[j][c] = fmaf(ww[j], S[j][c], kv);
        }
      }
      store_n(&yp[i][g * EV + c0], acc);
    };
    const int n = min(BT, p.T - blk * BT);
    if (n == BT) {
#pragma unroll
      for (int i = 0; i < BT; ++i) step(i);
    } else {
      for (int i = 0; i < n; ++i) step(i);
    }
  }
  block_sync();

#pragma unroll
  for (int j = 0; j < RPT; ++j) store_n(p.s_out + state + (long long)(d0 + j) * DH, S[j]);
}

template <typename T, int DH>
cudaError_t prepare() {
  // ask for the largest shared-memory carveout once, so that five CTAs fit
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_fwd<T, DH>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const cudaError_t err = prepare<T, DH>();
  if (err != cudaSuccess) return err;
  wkv6_fwd<T, DH><<<B * p.H * (DH / EV), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t info(int* out) {
  const cudaError_t err = prepare<T, DH>();
  if (err != cudaSuccess) return err;
  out[0] = EV;
  out[1] = NT;
  out[2] = (int)sizeof(Smem<T, DH>);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], wkv6_fwd<T, DH>, NT, 0);
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
// dimension contiguous, every pointer and the b/t/h strides 16-byte
// aligned (cp.async).  u: (H, dh) fp32 contiguous; s0 (may be null) and
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

// The schedule of one instantiation, into out[4]: value columns per CTA,
// threads per CTA, static shared memory bytes per CTA, CTAs resident per
// SM.  Returns a cudaError_t (0 on success).
extern "C" int wkv6_fwd_info(int is_bf16, int dh, void* out) {
  int* o = static_cast<int*>(out);
  if (dh != 32 && dh != 64) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)(dh == 32 ? info<__nv_bfloat16, 32>(o) : info<__nv_bfloat16, 64>(o));
  return (int)(dh == 32 ? info<float, 32>(o) : info<float, 64>(o));
}
