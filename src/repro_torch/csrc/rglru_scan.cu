// RG-LRU linear recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:27 (_rglru_kernel;
// grid (batch tiles, width tiles, time blocks) with the (block_b, block_w)
// carry in VMEM scratch across the sequential time axis):
//   h_t = a_t * h_{t-1} + b_t     per channel, fp32, from h0 (or zeros),
// each step rounded after the product and after the sum (__fmul_rn,
// __fadd_rn: no contraction into a fused multiply-add), so both kernels
// here equal the plain loop bit for bit.
//
// Bound.  Two reads and one write of (B, S, W) fp32 and one multiply-add
// per element: at the serving prefill shape (B=2, S=4096, W=4096) 0.403 GB,
// 0.120 ms at the H100 SXM's 3.35 TB/s, against 0.07 GFLOP, so it is bound
// by bytes.  The dependent chain is short beside it: 4096 steps of a
// multiply and an add take ~18 us per channel.  What a scan kernel has to
// do is keep enough reads in flight: by Little's law, ~1 us of loaded HBM
// latency at 3.35 TB/s asks for 2-3 MB across the card.
//
// Two kernels; the wrapper chooses by shape (rglru_scan.variant):
//
// "staged" (rglru_scan_staged_launch), every S > 1 with W % 4 == 0.  One
// CTA owns TW = 64 consecutive channels of one batch row (a 256-byte row per
// step and array) for the whole sequence: B * ceil(W / 64) CTAs, 128 at the
// serving shape, one per SM.  A producer warp's lane 0 stages blocks of
// TS = 32 steps of a and b into a ring of NS = 3 stages of dynamic shared
// memory by TMA: a 3-D tensor map over (W, S, B) per array and a (64, 32, 1)
// box, one instruction per array and block, completion counted on the
// stage's "full" mbarrier; out-of-bounds rows and channels (ragged S and W)
// come back as zeros.  Two blocks (32 KB) are in flight per CTA while the
// consumers run the third, ~4 MB across the card.  Two consumer warps run
// the recurrence out of shared memory, one channel per lane with the carry
// in a register; each warp stores its 32 channels of h at every step (so a
// CTA writes 256 contiguous bytes per step) and arrives on the stage's
// "empty" mbarrier, which the producer waits on before it refills the stage.
// The tile, the block and the ring depth are the fastest of a sweep on the
// H100 (tools/k2_variants.py): deeper rings and longer blocks, with more
// bytes in flight, measured up to 18 % slower, narrower tiles 1-4 %.  At
// this shape cp.async copies by the producer's 32 lanes and h stored from
// shared memory by TMA measured within 1 % of it, so the simpler pair of
// TMA loads and plain stores stays.  Time is not split into
// chunks scanned in parallel: that would read a and b twice (a carry pass)
// and change the order of the arithmetic, where this reads every byte once
// and keeps the plain loop's rounding.  Needs 16-byte aligned a, b, h and
// W % 4 == 0 (the tensor maps' strides); the wrapper checks both.
//
// "simple" (rglru_scan_fwd_launch), S == 1 (decode) and W % 4 != 0.  One thread
// per (batch, channel) in CTAs of 64, loading U = 16 steps ahead into
// registers.  At S = 1 there is nothing to stage, and the call encodes no
// tensor map on the host.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a * h + b rounded after the product and after the sum, as the reference
// computes it (no contraction into one fused multiply-add)
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ---- simple ----------------------------------------------------------------

constexpr int NT = 64;  // threads per CTA
constexpr int U = 16;   // steps loaded ahead

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

// ---- staged ----------------------------------------------------------------

constexpr int TW = 64;          // channels per CTA: one consumer lane each
constexpr int TS = 32;          // steps per staged block
constexpr int NS = 3;           // stages in the ring
constexpr int NCW = TW / 32;    // consumer warps; the producer warp follows them
constexpr int NTS = 32 * (NCW + 1);
constexpr int BLOCK_BYTES = TS * TW * 4;   // one array's box
static_assert(TW % 32 == 0, "whole consumer warps");

struct Ring {
  float a[NS][TS][TW];
  float b[NS][TS][TW];
  uint64_t full[NS];
  uint64_t empty[NS];
};
constexpr int STAGED_SMEM = sizeof(Ring) + 128;   // + slack to align the ring to 128 B
static_assert(STAGED_SMEM <= 232448, "more shared memory than a block may have");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(NTS) rglru_scan_staged(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const float* __restrict__ h0, float* __restrict__ h, int S, int W) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Ring& ring = *reinterpret_cast<Ring*>(smem_raw + (((raw + 127u) & ~127u) - raw));
  auto full = [&](int s) { return smem_u32(&ring.full[s]); };
  auto empty = [&](int s) { return smem_u32(&ring.empty[s]); };

  const int tiles = (W + TW - 1) / TW;
  const int bi = blockIdx.x / tiles;
  const int w0 = (blockIdx.x % tiles) * TW;
  const int nb = (S + TS - 1) / TS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);      // the producer's expect_tx; TMA completes the bytes
      mbar_init(empty(s), NCW);   // each consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {   // producer: lane 0 keeps NS blocks in flight
    if (lane == 0) {
      for (int blk = 0; blk < nb; ++blk) {
        const int s = blk % NS;
        if (blk >= NS) mbar_wait(empty(s), (blk / NS - 1) & 1);
        mbar_expect_tx(full(s), 2 * BLOCK_BYTES);
        tma_load(smem_u32(ring.a[s]), &ta, w0, blk * TS, bi, full(s));
        tma_load(smem_u32(ring.b[s]), &tb, w0, blk * TS, bi, full(s));
      }
    }
    return;
  }

  // consumer warp `warp`: thread c carries channel w0 + c, and the warp
  // stores its 32 channels of h at every step (128 contiguous bytes)
  const int c = threadIdx.x;
  const int w = w0 + c;
  const bool live = w < W;
  float hv = (h0 != nullptr && live) ? h0[(long long)bi * W + w] : 0.f;
  float* hp = h + (long long)bi * S * W + w;
  for (int blk = 0; blk < nb; ++blk) {
    const int s = blk % NS;
    mbar_wait(full(s), (blk / NS) & 1);
    const float(*as)[TW] = ring.a[s];
    const float(*bs)[TW] = ring.b[s];
    float* hb = hp + (long long)blk * TS * W;
    const int n = min(TS, S - blk * TS);
    if (n == TS) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        hv = step(as[i][c], hv, bs[i][c]);
        if (live) hb[(long long)i * W] = hv;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        hv = step(as[i][c], hv, bs[i][c]);
        if (live) hb[(long long)i * W] = hv;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // the warp is done with stage s
  }
}

// ---- host --------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver (libcuda), which this library
// does not link: fetch it through the runtime; null if the driver lacks it.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous (B, S, W) fp32 tensor, innermost first, whose
// box is TW channels x TS steps of one batch row; zeros outside the tensor.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {TW, TS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Allow the ring's dynamic shared memory and the largest carveout, once.
cudaError_t prepare_staged() {
  static bool done = false;
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGED_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(rglru_scan_staged,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
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

// The arguments of rglru_scan_fwd_launch; a, b and h 16-byte aligned and
// W % 4 == 0 (the tensor maps' strides).  Returns the cudaError_t of encoding
// the tensor maps and of the launch (cudaErrorSymbolNotFound if the driver
// has no cuTensorMapEncodeTiled).
extern "C" int rglru_scan_staged_launch(const void* a, const void* b, const void* h0,
                                        void* h, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || W % 4 != 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)h) % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long grid = (long long)B * ((W + TW - 1) / TW);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err;
  if ((err = encode(&ta, a, B, S, W)) != cudaSuccess) return (int)err;
  if ((err = encode(&tb, b, B, S, W)) != cudaSuccess) return (int)err;
  if ((err = prepare_staged()) != cudaSuccess) return (int)err;
  rglru_scan_staged<<<(unsigned)grid, NTS, STAGED_SMEM, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const float*>(h0), static_cast<float*>(h), S, W);
  return (int)cudaGetLastError();
}

// The staged kernel's schedule, into out[6]: channels per CTA, threads per
// CTA, stages in the ring, steps per stage, dynamic shared memory bytes per
// CTA, CTAs resident per SM.  Returns a cudaError_t (0 on success).
extern "C" int rglru_scan_staged_info(void* out) {
  int* o = static_cast<int*>(out);
  const cudaError_t err = prepare_staged();
  if (err != cudaSuccess) return (int)err;
  o[0] = TW;
  o[1] = NTS;
  o[2] = NS;
  o[3] = TS;
  o[4] = STAGED_SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[5], rglru_scan_staged, NTS,
                                                            STAGED_SMEM);
}
