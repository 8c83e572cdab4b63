// Flash attention forward on Hopper's tensor cores (sm_90a): bf16 q/k/v/o
// at d_head 64, 128 and 256.  Plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:35
// (_flash_kernel), with the GQA head expansion of ops.attention folded in
// by strides: softmax(softcap(scale * q k^T), causal / sliding-window /
// ragged-tail masked) v, an fp32 online softmax (masked keys give p = 0,
// also where a row's running max is still masked), p rounded to bf16
// before the PV product as the TPU kernel does (p.astype(v.dtype)), the
// denominator clamped at 1e-30, bf16 output.  Any Sq and Sk: tails are
// masked.  csrc/flash_attention.cu (fp32 SIMT) serves fp32 and the other
// head sizes; the wrapper chooses by dtype and head size only.
//
// Bound.  Operations: at yi-34b's prefill shape (B=4, S=2048, H=56, K=8,
// dh=128, causal) 4*B*H*dh*S(S+1)/2 = 240.6 GFLOP, 0.243 ms at the H100
// SXM's 989 TFLOP/s bf16 dense peak; q/k/v/o are 0.27 GB, 0.08 ms at 3.35
// TB/s.  At recurrentgemma-9b's (B=2, S=4096, H=16, K=1, dh=256, window
// 2048) 206.2 GFLOP, 0.209 ms.  At whisper-large-v3's encoder (B=16,
// Sq=Sk=1500, H=K=20, dh=64, non-causal) 4*B*H*dh*Sq*Sk = 184.3 GFLOP,
// 0.186 ms; its cross-attention (Sq=224, Sk=1500) moves 0.14 GB, 0.042 ms
// at 3.35 TB/s, against 27.5 GFLOP, 0.028 ms.  So the products must run on
// the tensor cores, which only wgmma drives at full rate.
//
// Design.  One CTA per (b*h, q tile) of one producer warp and 64-row
// consumer warpgroups (a wgmma's M): two at dh 64 and 128, one at dh 256.
// - The producer warp's lane 0 loads the CTA's q tile once and each K/V
//   tile into a 2-stage ring by TMA (4-D tensor maps over (dh, heads, S,
//   B), encoded per call from the wrapper's pointers and strides, 128-byte
//   swizzle).  A 128-byte box is 64 bf16 wide, so a tile lies in dh/64
//   column slabs of rows x 128 B.  Stage s has a "full" mbarrier (expect_tx
//   = the tile's bytes) and an "empty" one that every consumer warp
//   arrives on; the producer refills a stage once it is empty, so tile t+1
//   is in flight while tile t is multiplied.  Rows past S come back as
//   zeros; the mask does the rest.
// - S = q k^T: wgmma m64nBKk16, both operands K-major in shared memory
//   (the rows as they lie in memory), dh/16 k-steps in one commit group;
//   the descriptors step 32 B within a slab and one slab per 64 columns.
// - The online softmax runs on S's accumulator fragments in registers:
//   lane l of warp w owns rows 16w + l/4 and +8, columns 8j + 2(l%4) and
//   +1, so row max and row sum need shuffles among 4 lanes.  The scale
//   (times log2 e, for exp2f) is applied to the fp32 S; the TPU kernel
//   scales q in fp32 before the product, which differs by fp32 rounding.
// - O += P V: wgmma m64n(dh)k16 with A = P from registers (the fp32 S
//   fragments of one 16-column k-step, rounded to bf16 pairs, are exactly
//   wgmma's A fragment) and B = the V tile, which is (key, dh) row-major,
//   i.e. MN-major, read with the transpose bit.  O is rescaled by alpha
//   after the previous PV's wait_group, so no accumulator is touched while
//   a wgmma is in flight.
// - Masks are evaluated only on tiles that need them (the diagonal tile,
//   window edges, the ragged tail); a tile wholly above a warpgroup's
//   diagonal or wholly outside its window is not multiplied, and the KV
//   loop covers only the tiles the CTA's rows can see.
// - Epilogue: O / l in bf16 into the warpgroup's own q rows of shared
//   memory (same swizzle), then one TMA store per slab, which also clips
//   rows past Sq.
// - Grid (B*H, q tiles), x fastest: the heaviest causal q tiles of every
//   head go first, and the H/K query heads that share a KV head are
//   neighbours in launch order, so their K/V tiles are read from L2.
// Tiles: dh 128 takes 128-row q tiles (two warpgroups) and 128-key tiles:
// shared memory q 32 KB + 2 x (K 32 + V 32) = 160 KB, registers O 64 + S 64
// + P 32 per thread; ptxas allots 288 threads at most 168 registers and it
// needs 166, no spills.  The two warpgroups let the SM overlap one's
// softmax with the other's products.  dh 256 takes one warpgroup (64-row q
// tiles) and 64-key tiles: q 32 KB + 2 x 64 KB = 160 KB, O 128 + S 32 + P
// 16; two warpgroups there spilled at the 168-register cap.  160 KB allows
// one CTA per SM either way.  dh 64 is dh 128's schedule on one 128-byte
// slab: 128-row q tiles, 128-key tiles, q 16 KB + 2 x (K 16 + V 16) = 80
// KB, O 32 + S 64 + P 32 registers; QK^T is m64n128k16 in 4 k-steps, PV
// m64n64k16 with A from registers.  Two such CTAs would fit in shared
// memory but not in the registers (at most 112 a thread for 576 threads),
// so it stays at one CTA per SM too.
//
// Left for later: a warp-specialised producer warpgroup with setmaxnreg, a
// persistent schedule for the causal imbalance, ping-pong between the two
// consumer warpgroups and overlap of the softmax with the next tile's QK^T
// inside a warpgroup, and the backward kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;   // K/V ring depth
constexpr int ROW = 128;    // bytes of one row of a 64-column slab (the swizzle width)

template <int DH> struct Tiles {
  static constexpr int NWG = DH == 256 ? 1 : 2;      // consumer warpgroups, 64 query rows each
  static constexpr int BQ = 64 * NWG;                // query rows per CTA
  static constexpr int NT = 128 * NWG + 32;          // + one producer warp
  static constexpr int BK = DH == 256 ? 64 : 128;    // keys per K/V tile
  static constexpr int NSLAB = DH / 64;              // 128-byte column slabs
  static constexpr int Q_SLAB = BQ * ROW;            // bytes of one q slab
  static constexpr int KV_SLAB = BK * ROW;           // bytes of one K or V slab
  static constexpr int KV_TILE = NSLAB * KV_SLAB;    // bytes of one K (or V) tile
  static constexpr int K_OFF = NSLAB * Q_SLAB;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;   // barriers + 1024 B alignment slack
  static_assert(DH == 64 || DH == 128 || DH == 256, "wgmma variant: d_head 64, 128 or 256");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

struct Params {
  int H, KH, Sq, Sk;
  float scale, softcap;
  int causal, window;
};

// ---- shared memory, mbarriers, TMA ---------------------------------------

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
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands (q,
// K): 8-row groups 1024 B apart (SBO), LBO unused.  MN-major (V): LBO is
// the distance between 64-column slabs, SBO between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of these registers across
// the wgmma issue / wait_group around them.
template <int N> __device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---- wgmma products (operand lists written out: inline asm has no loops) ----

// D(64 x 64) (+)= A(64 x 16, smem, K-major) * B(16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 128) (+)= A(64 x 16, smem, K-major) * B(16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64) (+)= A(64 x 16, registers) * B(16 x 64, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// D(64 x 128) (+)= A(64 x 16, registers) * B(16 x 128, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// D(64 x 256) (+)= A(64 x 16, registers) * B(16 x 256, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, "
      "%130, %131}, %132, p, 1, 1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(Tiles<DH>::NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   const Params p) {
  using T = Tiles<DH>;
  constexpr int NWG = T::NWG, BQ = T::BQ, BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 B: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + T::K_OFF, sV = base + T::V_OFF;
  const uint32_t bars = base + T::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t qbar = bars + 8u * (2 * STAGES);

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest causal tiles first

  // the K/V tiles this CTA's rows can see: [t_lo, t_lo + n_tiles)
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q0 + BQ);
  const int kv_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_lo = kv_lo / BK;
  const int n_tiles = max(0, (kv_hi + BK - 1) / BK - t_lo);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);   // every consumer warp arrives
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {   // producer warp: lane 0 issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(qbar, NWG * T::NSLAB * 64 * ROW);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < T::NSLAB; ++c)
          tma_load(sQ + c * T::Q_SLAB + w * 64 * ROW, &tq, 64 * c, h, q0 + 64 * w, b, qbar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * T::KV_TILE);
        const int k0 = (t_lo + i) * BK;
        for (int c = 0; c < T::NSLAB; ++c) {
          tma_load(sK + s * T::KV_TILE + c * T::KV_SLAB, &tk, 64 * c, kh, k0, b, full(s));
          tma_load(sV + s * T::KV_TILE + c * T::KV_SLAB, &tv, 64 * c, kh, k0, b, full(s));
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  const int wg = warp / 4;
  const int wr = (warp % 4) * 16 + lane / 4;   // this lane's first row in the warpgroup
  const int qw0 = q0 + 64 * wg;
  const int qr0 = qw0 + wr, qr1 = qr0 + 8;     // its two rows
  const int cq = 2 * (lane % 4);               // its column pair in each group of 8
  const uint32_t q_rows = sQ + wg * 64 * ROW;

  float o[DH / 2], sc[BK / 2];
  uint32_t pa[BK / 4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this lane's partial sums
  const float scale_log2 = p.scale * LOG2E;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    const int k0 = (t_lo + i) * BK;
    const bool skip = (p.causal && k0 > qw0 + 63) ||
                      (p.window > 0 && k0 + BK - 1 <= qw0 - p.window);
    if (!skip) {
      // S = q K^T
      const uint32_t k_tile = sK + s * T::KV_TILE, v_tile = sV + s * T::KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < T::NSLAB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc, sw128_desc(q_rows + c * T::Q_SLAB + 32 * kk, 16, 1024),
                   sw128_desc(k_tile + c * T::KV_SLAB + 32 * kk, 16, 1024), c + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // scale (log2 domain), softcap, masks
      if (p.softcap != 0.f) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          sc[e] = p.softcap * tanhf(sc[e] * p.scale / p.softcap) * LOG2E;
      } else {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= scale_log2;
      }
      const bool edge = (p.causal && k0 + BK - 1 > qw0) ||
                        (p.window > 0 && k0 <= qw0 + 63 - p.window) || k0 + BK > p.Sk;
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + cq + (e & 1);
            const int qp = e < 2 ? qr0 : qr1;
            bool ok = kp < p.Sk;
            if (p.causal) ok = ok && qp >= kp;
            if (p.window > 0) ok = ok && kp > qp - p.window;
            if (!ok) sc[4 * j + e] = NEG_INF;
          }
      }

      // online softmax: fragment 4j + {0, 1} is row qr0, 4j + {2, 3} row qr1
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float e[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float x = sc[4 * j + t];
          // guard: a masked key gives p == 0, also where the row max is masked
          e[t] = x <= NEG_INF / 2 ? 0.f : exp2f(x - (t < 2 ? mn0 : mn1));
        }
        rs0 += e[0] + e[1];
        rs1 += e[2] + e[3];
        pa[2 * j] = pack_bf16(e[0], e[1]);       // p rounded to bf16 before PV
        pa[2 * j + 1] = pack_bf16(e[2], e[3]);
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      // O += P V: P's k-step kk is pa[4kk .. 4kk + 3], wgmma's A fragment
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                 sw128_desc(v_tile + 16 * ROW * kk, T::KV_SLAB, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      reg_fence(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // this warp is done with stage s
  }

  // epilogue: O / l in bf16 into this warpgroup's q rows, then TMA stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  uint8_t* const rows = smem + wg * 64 * ROW;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    uint8_t* const slab = rows + (j / 8) * T::Q_SLAB;
    const int chunk = j % 8;   // 16-byte chunk of the 128-byte row, before the swizzle
    *reinterpret_cast<uint32_t*>(slab + wr * ROW + ((chunk ^ (wr & 7)) << 4) + 2 * cq) =
        pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
    *reinterpret_cast<uint32_t*>(slab + (wr + 8) * ROW + ((chunk ^ ((wr + 8) & 7)) << 4) +
                                 2 * cq) = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // visible to TMA
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");      // this warpgroup only
  if (threadIdx.x % 128 == 0 && qw0 < p.Sq) {
    for (int c = 0; c < T::NSLAB; ++c) tma_store(&to, q_rows + c * T::Q_SLAB, 64 * c, h, qw0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
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

// A 4-D map over a (B, S, heads, dh) bf16 tensor, innermost first, whose
// box is 64 columns (128 B, the swizzle width) x `rows` positions of one head.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int dh,
                   long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
                   int Sq, int Sk, const long long (&st)[12], const Params& p,
                   cudaStream_t stream) {
  using T = Tiles<DH>;
  const int n_qt = (Sq + T::BQ - 1) / T::BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = encode(&tq, q, B, Sq, H, DH, st[0], st[1], st[2], 64)) != cudaSuccess) return err;
  if ((err = encode(&tk, k, B, Sk, KH, DH, st[3], st[4], st[5], T::BK)) != cudaSuccess) return err;
  if ((err = encode(&tv, v, B, Sk, KH, DH, st[6], st[7], st[8], T::BK)) != cudaSuccess) return err;
  if ((err = encode(&to, o, B, Sq, H, DH, st[9], st[10], st[11], 64)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, n_qt);
  flash_fwd_sm90<DH><<<grid, T::NT, T::SMEM, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

}  // namespace

// The arguments and the return value of flash_attention_fwd
// (csrc/flash_attention.cu): q, o (B, Sq, H, dh); k, v (B, Sk, KH, dh);
// strides in elements, the last dimension contiguous.  Takes is_bf16 = 1
// and dh 64, 128 or 256 only, 16-byte aligned pointers and strides (TMA);
// returns the cudaError_t of encoding the tensor maps and of the launch
// (cudaErrorSymbolNotFound if the driver has no cuTensorMapEncodeTiled).
extern "C" int flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int B, int H, int KH, int Sq, int Sk, int dh,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, float softcap, void* stream) {
  if (!is_bf16 || (dh != 64 && dh != 128 && dh != 256)) return (int)cudaErrorInvalidValue;
  if (KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  for (long long s : st)
    if ((s * 2) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params p{H, KH, Sq, Sk, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return (int)launch<64>(q, k, v, o, B, H, KH, Sq, Sk, st, p, s);
    case 128: return (int)launch<128>(q, k, v, o, B, H, KH, Sq, Sk, st, p, s);
    default: return (int)launch<256>(q, k, v, o, B, H, KH, Sq, Sk, st, p, s);
  }
}
