// Fused SwiGLU gate/up GEMM for Hopper, sm_90a: the mma.sync (bf16) and
// SIMT (fp32) variants.
//
// bf16 calls go to the wgmma kernel in fused_swiglu_wgmma.cu unless TMA
// cannot describe their rows (K or F not a multiple of 8, a base off a
// 16-byte boundary); those run the mma.sync kernel here (the rule:
// choose_variant in ../kernel.py).  fp32
// runs the CUDA-core kernel here: the fp32 tolerance of 2e-5 rules out
// the tensor cores.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/fused_swiglu/kernel.py:fused_swiglu_pallas (body
// _swiglu_kernel).  Same function:
//
//   h = silu(x Wg) * (x Wu)        x (M, K), Wg and Wu (K, F) -> h (M, F)
//
// with both products accumulated in fp32, the silu * mul epilogue in fp32
// and one rounding to the input dtype when h is written.  Neither (M, F)
// pre-activation is ever written to device memory.  An optional leading
// batch E with per-batch strides (x (E, M, K), W (E, K, F), h (E, M, F))
// runs every expert of a MoE layer in one launch; a dense MLP is E = 1.
//
// The TPU kernel walks K as the innermost, sequential grid axis and keeps
// the two accumulators in VMEM scratch across its steps.  Hopper's CTAs run
// in no order, so here each CTA owns one (M, F) output tile and walks K in
// a loop of its own, the accumulators in registers.  Each x tile is staged
// in shared memory once and feeds BOTH products: that is the fusion.
// Ragged M, K and F are masked in the tile loads, which fill with zeros
// (the TPU kernel pads with zeros, which gives the same sums), so the
// wrapper makes no padded copy.
//
// bf16: 128 x 128 output tiles (of h; 128 x 256 of products, g and u),
// 8 warps of 64 x 32, tensor cores through mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), operands from shared memory by ldmatrix (.trans for the
// row-major W tiles); rows padded by 16 bytes so ldmatrix reads hit
// distinct banks.  K in steps of 64 through a ring of three shared-memory
// stages (159,744 bytes, dynamic; one CTA an SM) filled by cp.async
// (16-byte copies that zero-fill out of range) when every row starts
// 16-byte aligned, else by element loads.  Gate and up accumulators share
// one register layout, so the epilogue applies silu(g) * u in registers
// and writes h once, rounded to bf16.
//
// fp32: 64 x 64 output tiles, 256 threads with a 4 x 4 micro-tile each of
// gate and up, fp32 FMA on the CUDA cores (not TF32: the fp32 tolerance is
// 2e-5); K in steps of 16 through two shared-memory buffers, the next tile
// staged in registers while the current one is multiplied.
//
// Bound.  At the model shapes the function is bound by operations:
// 4 M K F flops (two products) against (M K + 2 K F + M F) elements moved.
// llama3.2-3b's MLP at B = 2, S = 4096 (M 8192, K 3072, F 8192) is 825
// GFLOP against 151 MB of bf16, 5,460 flops a byte, far above the H100's
// 295 (989 TFLOP/s bf16 over 3.35 TB/s): 0.834 ms at the bf16 peak.
// granite-moe-1b-a400m's experts (E 32, M 2560, K 1024, F 512) are 172
// GFLOP, 0.174 ms.  Only wgmma reaches that peak; this version uses
// mma.sync and no warp specialisation, which cap it below.  Its first
// form (wmma fragments, 32 x 32 warp tiles) ran at 190-204 TFLOP/s on the
// H100 whether its ring held 2, 3 or 4 stages of K = 32 or 64 (PERF.md):
// the inner loop, not load latency, was the limit, so this one loads each
// fragment for more products (64 x 32 warp tiles: 8 ldmatrix.x4 feed 32
// mma).  wgmma on TMA-loaded tiles with a producer warpgroup is
// fused_swiglu_wgmma.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Params {
  const void* x;    // (E, M, K), rows of K elements, batch stride sx
  const void* wg;   // (E, K, F), rows of F elements, batch stride sw
  const void* wu;   // like wg
  void* h;          // (E, M, F), rows of F elements, batch stride sh
  int m, k, f;
  long long sx, sw, sh;
};

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BM = 128;              // output rows per CTA
constexpr int BN = 128;              // output columns per CTA
constexpr int BK = 64;               // K per stage
constexpr int STAGES = 3;            // cp.async ring depth
constexpr int THREADS = 256;         // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;      // a warp's tile of g and of u
constexpr int MT = WM / 16, NT = WN / 8;   // m16n8k16 tiles per warp
constexpr int XLD = BK + 8;          // padded row of an x tile (144 bytes)
constexpr int WLD = BN + 8;          // padded row of a W tile (272 bytes)
constexpr int X_TILE = BM * XLD;     // elements
constexpr int W_TILE = BK * WLD;
constexpr int STAGE = X_TILE + 2 * W_TILE;
constexpr int SMEM_BYTES = STAGES * STAGE * static_cast<int>(sizeof(bf16));
constexpr int X_CHUNKS = BM * BK / 8 / THREADS;   // 16-byte copies a thread
constexpr int W_CHUNKS = BK * BN / 8 / THREADS;
static_assert(X_CHUNKS * THREADS * 8 == BM * BK, "x tile split");
static_assert(W_CHUNKS * THREADS * 8 == BK * BN, "W tile split");
static_assert((BM / WM) * (BN / WN) * 32 == THREADS, "warp grid");
static_assert(STAGES >= 2, "the ring needs two stages");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  TRANS hands each thread the transposed
// elements, which turns row-major (k, n) tiles into the B operand.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const bf16* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

// d += a b for one m16n8k16 tile: bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy 8 consecutive elements of row r, starting at column c, of a
// (rows, cols) row-major matrix with leading dimension ld into smem;
// out-of-range elements become zero.
template <bool ALIGNED>
__device__ __forceinline__ void load8(bf16* smem, const bf16* base, int r,
                                      int c, int rows, int cols,
                                      long long ld) {
  if (ALIGNED) {   // cols % 8 == 0: a chunk is wholly in or wholly out
    const bool in = r < rows && c < cols;
    const bf16* src = in ? base + r * ld + c : base;
    cp_async16(smem, src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      smem[j] = (r < rows && c + j < cols) ? base[r * ld + c + j]
                                           : __float2bfloat16(0.0f);
    }
  }
}

template <bool ALIGNED>
__device__ __forceinline__ void load_stage(bf16* stage, const bf16* x,
                                           const bf16* wg, const bf16* wu,
                                           const Params& p, int m0, int n0,
                                           int k0) {
  const int t = threadIdx.x;
  bf16* xs = stage;
  bf16* gs = stage + X_TILE;
  bf16* us = gs + W_TILE;
#pragma unroll
  for (int i = 0; i < X_CHUNKS; ++i) {        // x tile: BM x BK
    const int c = t + i * THREADS;
    const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
    load8<ALIGNED>(xs + r * XLD + col, x, m0 + r, k0 + col, p.m, p.k, p.k);
  }
#pragma unroll
  for (int i = 0; i < W_CHUNKS; ++i) {        // W tiles: BK x BN each
    const int c = t + i * THREADS;
    const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
    load8<ALIGNED>(gs + r * WLD + col, wg, k0 + r, n0 + col, p.k, p.f, p.f);
    load8<ALIGNED>(us + r * WLD + col, wu, k0 + r, n0 + col, p.k, p.f, p.f);
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 1)
    swiglu_bf16_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const long long e = blockIdx.z;
  const bf16* x = static_cast<const bf16*>(p.x) + e * p.sx;
  const bf16* wg = static_cast<const bf16*>(p.wg) + e * p.sw;
  const bf16* wu = static_cast<const bf16*>(p.wu) + e * p.sw;
  bf16* h = static_cast<bf16*>(p.h) + e * p.sh;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / (BN / WN)) * WM;    // the warp's rows in the tile
  const int wn = (warp % (BN / WN)) * WN;    // and its columns
  // ldmatrix: lane l addresses row l % 16, column (l / 16) * 8 of a 16 x 16
  // block, for A (x, rows m) and for B (W, rows k) alike
  const int lr = lane % 16, lc = (lane / 16) * 8;

  float acc_g[MT][NT][4] = {}, acc_u[MT][NT][4] = {};

  // A ring of STAGES buffers: STAGES - 1 K-steps are in flight while one
  // is multiplied.  One commit group per K-step, empty past the end, so
  // waiting until at most STAGES - 2 groups are pending means step kt has
  // landed.
  const int nk = (p.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<ALIGNED>(smem + s * STAGE, x, wg, wu, p, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step kt is visible; step kt - 1's buffer is free
    const int next = kt + STAGES - 1;
    if (next < nk)
      load_stage<ALIGNED>(smem + (next % STAGES) * STAGE, x, wg, wu, p, m0,
                          n0, next * BK);
    cp_async_commit();
    const bf16* xs = smem + (kt % STAGES) * STAGE;
    const bf16* gs = xs + X_TILE;
    const bf16* us = gs + W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MT][4], bg[NT / 2][4], bu[NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4<false>(a[i], xs + (wm + i * 16 + lr) * XLD + kk + lc);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {   // two n8 tiles per x4.trans
        const int off = (kk + lr) * WLD + wn + j * 16 + lc;
        ldmatrix_x4<true>(bg[j], gs + off);
        ldmatrix_x4<true>(bu[j], us + off);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // x4.trans registers: (k0-7, n0-7), (k8-15, n0-7), (k0-7, n8-15),
          // (k8-15, n8-15)
          const int b = j / 2, h2 = (j % 2) * 2;
          mma_bf16(acc_g[i][j], a[i], bg[b][h2], bg[b][h2 + 1]);
          mma_bf16(acc_u[i][j], a[i], bu[b][h2], bu[b][h2 + 1]);
        }
    }
  }
  cp_async_wait<0>();

  // epilogue: h = silu(g) * u in fp32 registers, written once as bf16.  In
  // an m16n8 accumulator thread t holds rows t/4 and t/4 + 8, columns
  // (t % 4) * 2 and + 1.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = m0 + wm + i * 16 + lane / 4 + (v / 2) * 8;
        const int c = n0 + wn + j * 8 + (lane % 4) * 2 + v % 2;
        if (r < p.m && c < p.f)
          h[static_cast<long long>(r) * p.f + c] = __float2bfloat16(
              silu_mul(acc_g[i][j][v], acc_u[i][j][v]));
      }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int FLD = FBM + 4;         // padded row of the transposed x tile

__global__ void __launch_bounds__(THREADS)
    swiglu_f32_kernel(Params p) {
  __shared__ __align__(16) float xs[2][FBK][FLD];   // x tile, transposed
  __shared__ __align__(16) float gs[2][FBK][FBN];
  __shared__ __align__(16) float us[2][FBK][FBN];

  const int n0 = blockIdx.x * FBN;
  const int m0 = blockIdx.y * FBM;
  const long long e = blockIdx.z;
  const float* x = static_cast<const float*>(p.x) + e * p.sx;
  const float* wg = static_cast<const float*>(p.wg) + e * p.sw;
  const float* wu = static_cast<const float*>(p.wu) + e * p.sw;
  float* h = static_cast<float*>(p.h) + e * p.sh;

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;   // 4 x 4 micro-tile at (ty, tx)
  // loads: x row t/4, columns (t%4)*4..+3; W row t/16, columns (t%16)*4..+3
  const int xr = t / 4, xc = (t % 4) * 4;
  const int wr = t / 16, wc = (t % 16) * 4;

  float rx[4], rg[4], ru[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + xr, c = k0 + xc + j;
      rx[j] = (r < p.m && c < p.k) ? x[static_cast<long long>(r) * p.k + c]
                                   : 0.0f;
      const int kr = k0 + wr, n = n0 + wc + j;
      const bool in = kr < p.k && n < p.f;
      const long long o = static_cast<long long>(kr) * p.f + n;
      rg[j] = in ? wg[o] : 0.0f;
      ru[j] = in ? wu[o] : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[buf][xc + j][xr] = rx[j];
      gs[buf][wr][wc + j] = rg[j];
      us[buf][wr][wc + j] = ru[j];
    }
  };

  float acc_g[4][4] = {}, acc_u[4][4] = {};
  const int nk = (p.k + FBK - 1) / FBK;
  if (nk > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * FBK);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&gs[buf][kk][tx * 4]);
      const float4 u = *reinterpret_cast<const float4*>(&us[buf][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_g[i][j] = fmaf(av[i], gv[j], acc_g[i][j]);
          acc_u[i][j] = fmaf(av[i], uv[j], acc_u[i][j]);
        }
    }
    if (kt + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < p.f)
        h[static_cast<long long>(r) * p.f + c] =
            silu_mul(acc_g[i][j], acc_u[i][j]);
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool ALIGNED>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      swiglu_bf16_kernel<ALIGNED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  swiglu_bf16_kernel<ALIGNED><<<grid, THREADS, SMEM_BYTES, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int fused_swiglu_fwd(const void* x, const void* wg,
                                const void* wu, void* h, int batch, int m,
                                int k, int f, long long sx, long long sw,
                                long long sh, int dtype, void* stream) {
  if (batch < 0 || m < 0 || k < 0 || f < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || m == 0 || f == 0) return 0;
  const Params p{x, wg, wu, h, m, k, f, sx, sw, sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bm = dtype == 1 ? BM : FBM;
  const int bn = dtype == 1 ? BN : FBN;
  const long long gy = (static_cast<long long>(m) + bm - 1) / bm;
  if (gy > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((f + bn - 1) / bn, static_cast<unsigned>(gy), batch);
  if (dtype == 0) {
    swiglu_f32_kernel<<<grid, THREADS, 0, s>>>(p);
  } else {
    // 16-byte copies need every row of x, Wg and Wu to start 16-byte aligned
    const bool aligned = k % 8 == 0 && f % 8 == 0 && sx % 8 == 0 &&
                         sw % 8 == 0 && aligned16(x) && aligned16(wg) &&
                         aligned16(wu);
    return static_cast<int>(aligned ? launch_bf16<true>(p, grid, s)
                                    : launch_bf16<false>(p, grid, s));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_swiglu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
