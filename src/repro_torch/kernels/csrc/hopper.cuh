// Hopper (sm_90a) primitives shared by the port's wgmma kernels.
//
// Small inline-PTX helpers, in the order a warp-specialised kernel uses
// them: mbarriers for the producer/consumer ring, TMA tensor loads into
// shared memory, wgmma shared-memory descriptors for the 128-byte swizzle,
// the wgmma fences and the m64nNk16 bf16 -> fp32 products (both operands
// in shared memory, "SS", or A in registers, "RS"), the m64nNk8 tf32
// products with the operand split that makes them fp32-accurate, the
// swizzled address of a 32-bit element and the proxy fence for tiles that
// threads store themselves, setmaxnreg, and the host-side encoding of a
// TMA tensor map.  Raw PTX, no CUTLASS: each nvcc build stays at seconds.
//
// Layout conventions (PTX ISA, "Shared Memory Matrix Layout"):
//  * A TMA box whose inner extent is 64 bf16 (128 bytes), loaded with
//    CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned buffer, lands as
//    rows of 128 bytes whose 16-byte chunks are XOR-ed with row % 8: the
//    SW128 atom of 8 rows x 128 bytes.
//  * K-major operand (K contiguous, e.g. Q and K tiles of attention, x of a
//    GEMM): rows of M or N, SBO = 1024 bytes between 8-row groups, LBO
//    unused (1).  The k-th 16-element step inside the 64-wide atom starts
//    32 k bytes further; the hardware applies the swizzle to the address.
//  * MN-major operand (N contiguous, e.g. V of attention, W (K, F) of a
//    GEMM): rows of K, SBO = 1024 bytes between 8-row groups of K, LBO =
//    the byte distance between the 64-wide atoms along N; the wgmma
//    transpose bit is set.  The k-th 16-row step starts 2048 k bytes on.
//
// Everything here is a header of inline functions; each kernel library
// that includes it gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// shared-memory addresses
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The warpgroup of this thread, broadcast from lane 0 so the compiler
// knows it is the same across the warp: a branch or loop bound on it is not
// a divergent path, which would make ptxas serialise the wgmmas inside it.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call once after the inits, before a block barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Cycles after which a wait is taken for a deadlock (~9 s at 1.98 GHz):
// the kernel traps, so the launch fails with an error instead of hanging
// the card.
constexpr long long WAIT_TIMEOUT_CYCLES = 1ll << 34;

// Spins until the barrier's phase of parity `parity` has completed (its
// current phase parity differs from `parity`).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > WAIT_TIMEOUT_CYCLES) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA: tensor tiles from global into shared memory, completion counted on
// an mbarrier in bytes.  `tmap` is the generic address of a
// __grid_constant__ CUtensorMap parameter; coordinates are innermost first.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma shared-memory descriptors, 128-byte swizzle
// ---------------------------------------------------------------------------

// bits 0-13 start address >> 4, 16-29 LBO >> 4, 32-45 SBO >> 4, 62-63 the
// layout (1 = 128-byte swizzle); the base offset (49-51) stays 0 because
// every swizzle atom starts 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// K-major: rows of M (or N), 128-byte rows, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major: rows of K, 8-row groups 1024 bytes apart, the 64-wide atoms
// along N `atom_stride` bytes apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t atom_stride) {
  return sw128_desc(addr, atom_stride, 1024);
}

// ---------------------------------------------------------------------------
// wgmma synchronisation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_array(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---------------------------------------------------------------------------
// wgmma m64nNk16, bf16 x bf16 -> fp32.  d[N / 2] per thread; `accumulate`
// 0 overwrites d.  SS: A and B from shared memory (A K-major); RS: A from
// registers (four .b32 of two bf16 each, the m16n8k16 A layout per warp).
// TRANS_B 1 reads B MN-major.  Register 4 i + j of d holds row
// 16 (warp % 4) + lane / 4 + 8 (j / 2), column 8 i + 2 (lane % 4) + j % 2.
// ---------------------------------------------------------------------------

#define HOPPER_R8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, %51;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n112(float (&d)[56], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55}, %56, %57, p, 1, 1, 0, %59;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40), HOPPER_R8(48)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, %67;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40), HOPPER_R8(48), HOPPER_R8(56)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40), HOPPER_R8(48), HOPPER_R8(56),
        HOPPER_R8(64), HOPPER_R8(72), HOPPER_R8(80), HOPPER_R8(88),
        HOPPER_R8(96), HOPPER_R8(104), HOPPER_R8(112), HOPPER_R8(120)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40), HOPPER_R8(48), HOPPER_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate), "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// wgmma m64nNk8, tf32 x tf32 -> fp32, both operands in shared memory and
// K-major (PTX has no transpose bit for .tf32: an operand whose reduction
// axis is its row axis in device memory is transposed on its way into
// shared memory).  A tf32 operand is a 32-bit float whose low 13 mantissa
// bits the tensor core does not read.  d[N / 2] per thread, in the same
// register layout as the bf16 products above.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : HOPPER_R8(0), HOPPER_R8(8), HOPPER_R8(16), HOPPER_R8(24),
        HOPPER_R8(32), HOPPER_R8(40), HOPPER_R8(48), HOPPER_R8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef HOPPER_R8

// N-generic front ends, so a kernel templated on a width calls one name.
template <int N, int TRANS_B>
struct Wgmma;
template <int TRANS_B>
struct Wgmma<64, TRANS_B> {
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    wgmma_rs_n64<TRANS_B>(d, a, b, acc);
  }
};
template <int TRANS_B>
struct Wgmma<96, TRANS_B> {
  __device__ __forceinline__ static void ss(float (&d)[48], uint64_t a,
                                            uint64_t b, int acc) {
    wgmma_ss_n96<TRANS_B>(d, a, b, acc);
  }
};
template <int TRANS_B>
struct Wgmma<112, TRANS_B> {
  __device__ __forceinline__ static void ss(float (&d)[56], uint64_t a,
                                            uint64_t b, int acc) {
    wgmma_ss_n112<TRANS_B>(d, a, b, acc);
  }
};
template <int TRANS_B>
struct Wgmma<128, TRANS_B> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
    wgmma_ss_n128<TRANS_B>(d, a, b, acc);
  }
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    wgmma_rs_n128<TRANS_B>(d, a, b, acc);
  }
};

// ---------------------------------------------------------------------------
// fp32-accurate products on the tf32 tensor cores ("3xTF32")
//
// a = hi + lo with hi = a rounded to tf32 (round to nearest, ties away) and
// lo = a - hi (exact in fp32) rounded to tf32 again; a product is then
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three tf32 passes into one fp32
// accumulator.  What is left out (lo_a lo_b and the rounding of lo) is
// about 2^-22 of |a b|, against 2^-11 for one tf32 pass.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - hi);
}

__device__ __forceinline__ void split_tf32(const float4& a, float4& hi,
                                           float4& lo) {
  split_tf32(a.x, hi.x, lo.x);
  split_tf32(a.y, hi.y, lo.y);
  split_tf32(a.z, hi.z, lo.z);
  split_tf32(a.w, hi.w, lo.w);
}

// Byte offset of element (row, k), 0 <= k < 32, inside one 128-byte-swizzle
// atom of 32-bit elements: rows of 128 bytes, the 16-byte chunk k / 4
// XOR-ed with row % 8 (what TMA's SWIZZLE_128B writes and a K-major
// descriptor reads).  An operand tile of R rows x K columns is K / 32 such
// atoms of R * 128 bytes, each 1024-byte aligned; its k8 step s starts
// (s / 4) R 128 + (s % 4) 32 bytes on.
__device__ __forceinline__ uint32_t sw128_f32_offset(int row, int k) {
  return static_cast<uint32_t>(row * 128 +
                               ((((k >> 2) ^ row) & 7) << 4) + ((k & 3) << 2));
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (wgmma, TMA); call after the stores and before
// the barrier that hands the tile to the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp, subnormal results flushed
// to zero); one instruction, where exp2f adds range handling.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one .b32 of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// register rebalancing between warpgroups (the whole warpgroup executes it)
//
// With CUDA 12.8's ptxas the consumer code of a 384-thread kernel is still
// compiled within the 168 registers a thread has at launch (no register
// above R167 in its SASS at setmaxnreg.inc 232 or 240), so a kernel sizes
// its consumer state to 168; the instruction still pays (tools/
// kernel_ablation.py times both kernels without it).  Launch whole
// warpgroups: with 288 threads ptxas still allotted 168 a thread, and
// setmaxnreg.inc 232 then waited forever for registers the CTA never had.
// ---------------------------------------------------------------------------

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps.  cuTensorMapEncodeTiled is a driver function; it
// is looked up through the runtime, so the library needs no -lcuda.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, `dims` in elements,
// `strides_bytes` for dims 1..rank-1), box `box`, 128-byte swizzle;
// elements outside the tensor read as zero.  Returns false on failure.
inline bool encode_bf16_sw128(CUtensorMap* map, const void* base, int rank,
                              const uint64_t* dims,
                              const uint64_t* strides_bytes,
                              const uint32_t* box) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides_bytes[i];
  }
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), gdim, gstride, bdim, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

}  // namespace hopper
