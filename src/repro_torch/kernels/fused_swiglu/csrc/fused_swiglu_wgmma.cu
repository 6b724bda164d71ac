// Fused SwiGLU gate/up GEMM, bf16, for Hopper (sm_90a): wgmma on TMA tiles.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/fused_swiglu/kernel.py:fused_swiglu_pallas (body
// _swiglu_kernel) for bf16 inputs whose rows TMA can describe.  Same
// function as fused_swiglu.cu, which stays for fp32 and for the shapes
// this one does not take:
//
//   h = silu(x Wg) * (x Wu)        x (E, M, K), Wg and Wu (E, K, F) -> h
//
// both products accumulated in fp32, the silu * mul epilogue in fp32 and
// one rounding to bf16 when h is written; neither pre-activation reaches
// device memory.  A dense MLP is E = 1.
//
// Bound.  4 E M K F flops against (M K + 2 K F + M F) E elements: at the
// prefill shapes thousands of flops a byte, bound by operations (0.834 ms
// at llama3.2-3b's MLP, 0.174 ms at granite-moe-1b-a400m's experts, at
// 989 TFLOP/s).  Only wgmma reaches that rate.
//
// Design.  A persistent grid of one CTA per SM walks 128 x 128 tiles of h
// (grouped 8 tile rows at a time so neighbouring CTAs share x rows and W
// columns in L2; experts one after another).  Each CTA has three
// warpgroups:
//  * warpgroup 2 is the producer: it gives up registers (setmaxnreg) and one
//    thread TMA-loads, per K step of 64, the x tile (128 x 64, K-major) and
//    the Wg and Wu tiles (64 x 128 each, two 64-column boxes, MN-major: W
//    is (K, F) row-major) into a ring of STAGES stages with a full and an
//    empty mbarrier each.  It runs ahead across tile boundaries, so the
//    next tile's loads overlap this tile's epilogue.  3-D tensor maps over
//    (E, rows, cols) zero-fill ragged M, K and F.
//  * warpgroups 0 and 1 own 64 rows each and hold both accumulators, g and
//    u, 64 x 128 fp32 each: 128 registers a thread, hence setmaxnreg.
//    A stage's Wg and Wu tiles lie side by side, four 64-column atoms at
//    one stride, so ONE wgmma m64n256k16 per 16-deep step computes
//    [g | u] from each x tile (that is the fusion): x is read from shared
//    memory once, not once per product.  Shared-memory bandwidth is the
//    limit here (operand reads plus TMA writes): at the full tensor rate
//    two m64n128k16 products would need ~143 bytes a clock of the 128 an
//    SM has, one m64n256k16 ~127.  W is read through the descriptor's transpose
//    bit.  One wgmma group stays in flight while the next stage is
//    awaited; a stage is released to the producer when the group that
//    read it has retired.
//  * The epilogue computes silu(g) * u in fp32 registers and stores bf16
//    pairs, masked to M and F.
//
// TMA needs 16-byte aligned bases and row strides: K and F multiples of 8.
// The wrapper sends other shapes to fused_swiglu.cu's mma.sync kernel by a
// written rule (choose_variant in ../kernel.py).
//
// Shared memory: STAGES x (16 KB x + 16 KB Wg + 16 KB Wu) + barriers + 1 KB
// to align the base: 197,696 bytes (wgmma_smem_bytes in ../kernel.py).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;        // rows of h per tile: two consumer warpgroups
constexpr int BN = 128;        // columns of h per tile
constexpr int BK = 64;         // K per stage: one 128-byte swizzle atom
constexpr int STAGES = 4;
constexpr int GROUP_M = 8;     // tile rows walked together
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BYTES = BK * BN * 2;            // two 64 x 64 boxes each
constexpr int W_BOX_BYTES = BK * 64 * 2;
constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM_ALLOC = BAR_OFF + 2 * STAGES * 8 + 1024;

struct Params {
  void* h;
  int e, m, k, f;
  int tiles_m, tiles_n;
};

// silu(g) * u in fp32 with the hardware's approximate exp and divide
// (a few ulp of fp32, far below the one bf16 rounding that follows): the
// accurate expf and division cost the kernel 9-20% of its time
// (tools/kernel_ablation.py, accurate_epilogue).
__device__ __forceinline__ float silu_mul(float g, float u) {
  return __fdividef(g, 1.0f + __expf(-g)) * u;
}

// tile t -> (expert, first row, first column)
__device__ __forceinline__ void tile_coords(const Params& p, int t, int& e,
                                            int& m0, int& n0) {
  const int per_expert = p.tiles_m * p.tiles_n;
  e = t / per_expert;
  const int r = t % per_expert;
  const int group = r / (GROUP_M * p.tiles_n);
  const int first_m = group * GROUP_M;
  const int rows = min(p.tiles_m - first_m, GROUP_M);
  const int in_group = r % (GROUP_M * p.tiles_n);
  m0 = (first_m + in_group % rows) * BM;
  n0 = (in_group / rows) * BN;
}

__global__ void __launch_bounds__(THREADS, 1)
    swiglu_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tu,
                        const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto x_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto g_s = [&](int s) { return base + s * STAGE_BYTES + X_BYTES; };
  auto full = [&](int s) { return base + BAR_OFF + 8u * s; };
  auto empty = [&](int s) { return base + BAR_OFF + 8u * (STAGES + s); };

  const int tiles = p.e * p.tiles_m * p.tiles_n;
  const int nk = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // lane 0 of each of the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int e, m0, n0;
        tile_coords(p, t, e, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
          mbar_arrive_expect_tx(full(s), STAGE_BYTES);
          const int k0 = kt * BK;
          tma_load_3d(x_s(s), &tx, full(s), k0, m0, e);
          tma_load_3d(g_s(s), &tg, full(s), n0, k0, e);
          tma_load_3d(g_s(s) + W_BOX_BYTES, &tg, full(s), n0 + 64, k0, e);
          tma_load_3d(g_s(s) + W_BYTES, &tu, full(s), n0, k0, e);
          tma_load_3d(g_s(s) + W_BYTES + W_BOX_BYTES, &tu, full(s), n0 + 64,
                      k0, e);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    __nv_bfloat16* hp = static_cast<__nv_bfloat16*>(p.h);
    float acc[BN];   // [g | u]: registers 0-63 are g, 64-127 u
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0;
      tile_coords(p, t, e, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc_k_major(x_s(s) + wg * 64 * 128 + kk * 32);
          const uint64_t dw = desc_mn_major(g_s(s) + kk * 16 * 128,
                                            W_BOX_BYTES);
          wgmma_ss_n256<1>(acc, da, dw, kt > 0 || kk > 0);
        }
        wgmma_commit();
        // the group of the previous K step has retired: free its stage
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(empty((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_array(acc);
      if (lane == 0) mbar_arrive(empty((it - 1) % STAGES));

      // epilogue: register 4i + j holds row (j < 2 ? lo : hi), column
      // 8i + 2 (lane % 4) + j % 2 of the warpgroup's 64 x 256 [g | u] tile;
      // u's column c is g's register + 64
      const int row_lo = m0 + wg * 64 + warp * 16 + lane / 4;
      const int row_hi = row_lo + 8;
      __nv_bfloat16* he = hp + static_cast<long long>(e) * p.m * p.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * (lane % 4);
        if (col >= p.f) continue;
        if (row_lo < p.m)
          *reinterpret_cast<uint32_t*>(
              he + static_cast<long long>(row_lo) * p.f + col) =
              pack_bf16(silu_mul(acc[4 * i], acc[64 + 4 * i]),
                        silu_mul(acc[4 * i + 1], acc[65 + 4 * i]));
        if (row_hi < p.m)
          *reinterpret_cast<uint32_t*>(
              he + static_cast<long long>(row_hi) * p.f + col) =
              pack_bf16(silu_mul(acc[4 * i + 2], acc[66 + 4 * i]),
                        silu_mul(acc[4 * i + 3], acc[67 + 4 * i]));
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  bf16 only; x (E, M, K), wg and
// wu (E, K, F), h (E, M, F), all contiguous, 16-byte aligned, K and F
// multiples of 8, K > 0.  Returns a cudaError_t (0 on success); the kernel
// runs on `stream` and nothing is synchronised.
extern "C" int fused_swiglu_fwd_wgmma(const void* x, const void* wg,
                                      const void* wu, void* h, int batch,
                                      int m, int k, int f, void* stream) {
  if (batch <= 0 || m <= 0 || k <= 0 || f <= 0 || k % 8 || f % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t xd[3] = {static_cast<uint64_t>(k),
                          static_cast<uint64_t>(m),
                          static_cast<uint64_t>(batch)};
  const uint64_t xs[2] = {static_cast<uint64_t>(k) * 2,
                          static_cast<uint64_t>(m) * k * 2};
  const uint32_t xb[3] = {BK, BM, 1};
  const uint64_t wd[3] = {static_cast<uint64_t>(f),
                          static_cast<uint64_t>(k),
                          static_cast<uint64_t>(batch)};
  const uint64_t ws[2] = {static_cast<uint64_t>(f) * 2,
                          static_cast<uint64_t>(k) * f * 2};
  const uint32_t wb[3] = {64, BK, 1};
  CUtensorMap tx, tg, tu;
  if (!encode_bf16_sw128(&tx, x, 3, xd, xs, xb) ||
      !encode_bf16_sw128(&tg, wg, 3, wd, ws, wb) ||
      !encode_bf16_sw128(&tu, wu, 3, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.h = h;
  p.e = batch;
  p.m = m;
  p.k = k;
  p.f = f;
  p.tiles_m = (m + BM - 1) / BM;
  p.tiles_n = (f + BN - 1) / BN;
  const long long tiles =
      static_cast<long long>(batch) * p.tiles_m * p.tiles_n;
  const int sms = sm_count();
  if (sms <= 0 || tiles >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_ALLOC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  swiglu_wgmma_kernel<<<grid, THREADS, SMEM_ALLOC,
                        static_cast<cudaStream_t>(stream)>>>(tx, tg, tu, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_swiglu_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
