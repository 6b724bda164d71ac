// SSD (mamba2) intra-chunk scan for Hopper (sm_90a): fp32-accurate
// products on the tf32 tensor cores through wgmma.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssm_scan/kernel.py:ssd_chunk_pallas (body
// _ssd_chunk_kernel) at the shapes of zamba2-7b's mamba layers (state size
// N = head dim P = 64, chunks of Q = 64..256 rows, Q a multiple of 64).
// Same function as ssd_chunk.cu, which stays for the other widths and
// chunk lengths (the wrapper's written rule, choose_variant in
// ../kernel.py), per (batch, chunk, head), in fp32:
//
//   dA_cum  = cumsum(dt * -exp(A_log))            (Q, summed in fp64)
//   L[i,j]  = exp(dA_cum[i] - dA_cum[j]) if i >= j, else 0 (a select)
//   y_diag  = ((C B^T) o L o dt_j) X              (Q, P)
//   states  = B^T (dt o exp(dA_cum[Q-1] - dA_cum) o X)   (N, P)
//   chunk_lf = dA_cum[Q-1]
//
// Bound.  At zamba2-7b's prefill shape (b 2, S 4096, Q 256, h 112) the
// function needs 22.7 GFLOP (C B^T once per (batch, chunk), the rest per
// head) against 536 MB of fp32 inputs and outputs: 0.046 ms at the tf32
// tensor-core peak (495 TFLOP/s), 0.160 ms at 3.35 TB/s, so bound by
// bytes.  The three tf32 passes below make the tensor work 68 GFLOP,
// 0.14 ms.
//
// Accuracy: 3xTF32.  The kernel tests hold it to rtol = atol = 1e-4
// against the fp32 twin; one tf32 pass misses that by 450x at the path
// shape (tools/kernel_ablation.py, single_tf32; the CPU emulation in
// tests/test_torch_split_precision.py shows it too).  Every operand is
// split a = hi + lo (hopper.cuh: split_tf32, hi and lo rounded to
// nearest) and each product is lo_a hi_b + hi_a lo_b + hi_a hi_b, three
// tf32 wgmmas into one fp32 accumulator.  Worst error against the twin on
// an H100: 2.9e-4 absolute over chip_smoke.py's cases (|y| reaches
// hundreds), 0.41 of the tolerance at the path shape
// (tools/kernel_ablation.py); the CPU emulation stays under half of it.
// (A three-term bf16 split, six products, was as accurate in the
// emulation and would cost the same tensor time; tf32 issues half the
// wgmmas and splits once.)  wgmma reads .tf32 operands only K-major, so
// X, and B and X in the state, whose reduction axis (keys) is their row
// axis, are transposed on their way into shared memory: all tiles are
// loaded by the threads (128-byte rows), split in registers and stored in
// the 128-byte swizzle the descriptors read.  TMA would land the raw fp32
// tile, which still has to pass through registers to be split, so it is
// not used here.
//
// Design.  One CTA of three warpgroups per (batch, chunk, 64-row query
// tile, group of 8 heads): 4 x 32 x 14 = 1,792 CTAs at the path shape, the
// four query tiles of a (chunk, head group) next to each other in the grid
// so their X tiles are read from L2 once they are there.
//  1. S = C_tile B^T for the key tiles up to the diagonal (the tiles above
//     it are never visited): all threads split C and B, one warpgroup
//     multiplies; S is kept in shared memory (fp32, row-major) for all the
//     CTA's heads, so C B^T is computed once per 8 heads instead of per
//     head (16 GFLOP of the old kernel's 37.7 no longer done).
//  2. The rest is a list of work items, per head the y key tiles 0..it
//     and, in the CTA of query tile 0 (which has only one y tile), the
//     state's key tiles.  Item n goes through stage n % 2 of a two-stage
//     ring (A and B tiles, hi and lo: 64 KB each) behind full and empty
//     mbarriers, filled by producer warpgroup n % 2 and consumed by the
//     third warpgroup, which runs the 24 wgmma m64n64k8 of the item and
//     writes y (or the state) after a head's last item.  A y item: A = W
//     = S o L o dt_j, formed from S with the head's fp64 dA_cum (each
//     producer scans dt itself), B = X's key tile transposed.  A state
//     item: A = B^T, B = (dt o decay o X)^T.  Forming W (an exp and a
//     split per element) is the bulk of the work, so it is what the two
//     producers share; one warpgroup issues all the products.
// Shared memory: S (66,560 bytes), the two stages (131,072), the barriers
// and each producer's dt, dA_cum and state weights, and 1 KB to align the
// base: 206,944 bytes, one CTA an SM.  At the path shape it takes 0.93 ms
// on an H100 80GB HBM3 at 700 W (chip_smoke.py), 0.17 of the bound.
// Earlier layouts measured slower there: S in registers with one
// warpgroup a CTA (255 registers, spilled), and two warpgroups each
// forming and multiplying its own items.  The producers' W builds, not
// the tensor cores, bound it: one tf32 pass instead of three saves only
// 8% (tools/kernel_ablation.py, single_tf32).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;            // query rows, key rows
constexpr int WIDTH = 64;           // N and P
constexpr int WG_THREADS = 128;
constexpr int WG_WARPS = WG_THREADS / 32;
constexpr int THREADS = 3 * WG_THREADS;   // warpgroups 0, 1 produce; 2 consumes
constexpr int HEADS = 8;            // heads per CTA
constexpr int MAX_Q = 256;
constexpr int ATOM = TILE * 128;            // 64 rows x 32 fp32, bytes
constexpr int TILE_BYTES = 2 * ATOM;        // 64 x 64 fp32
// S = C_tile B^T, row-major, rows padded so float4 reads of a row and the
// accumulator's float2 writes spread over the banks
constexpr int S_LD = MAX_Q + 4;
constexpr int S_BYTES = TILE * S_LD * 4;    // 66,560: a multiple of 1024
// a stage of the ring: the A tile and the B tile, hi and lo each
constexpr int A_HI = 0, A_LO = TILE_BYTES, B_HI = 2 * TILE_BYTES,
              B_LO = 3 * TILE_BYTES, STAGE_BYTES = 4 * TILE_BYTES;
constexpr int STAGES = 2;           // one for each producer warpgroup
constexpr int BAR_OFF = S_BYTES + STAGES * STAGE_BYTES;
// per producer: dt, dA_cum (fp64), the state weights, the scan's warp sums
constexpr int DT_OFF = 0, CUM_OFF = MAX_Q * 4, WJ_OFF = CUM_OFF + MAX_Q * 8,
              WSUM_OFF = WJ_OFF + MAX_Q * 4,
              SCAL_BYTES = WSUM_OFF + WG_WARPS * 8;
constexpr int SCAL_BASE = BAR_OFF + 2 * STAGES * 8;
constexpr int SMEM_ALLOC = SCAL_BASE + 2 * SCAL_BYTES + 1024;

struct Params {
  const float* x;      // (b, nc, Q, h, P)
  const float* dt;     // (b, nc, Q, h)
  const float* a_log;  // (h)
  const float* B;      // (b, nc, Q, N)
  const float* C;      // (b, nc, Q, N)
  float* y;            // (b, nc, Q, h, P)
  float* states;       // (b, nc, h, N, P)
  float* chunk_lf;     // (b, nc, h)
  int q, h, groups;
};

// The barrier of warpgroup wg alone (barrier 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// e^x as 2^(x log2 e) by the SFU: about 2 ulp beside expf's one, where
// the fp32 argument's own rounding (the kernel and the twin both round
// dA_cum[i] - dA_cum[j] to fp32 first) is already ~|x| 6e-8; expf's
// range handling was a fifth of an earlier version's time.  Results below
// 2^-126 flush to zero.
__device__ __forceinline__ float exp_fast(float x) {
  return exp2_approx(x * 1.4426950408889634f);
}

// Element (row, column c .. c + 3) of a 64 x 64 K-major operand tile.
__device__ __forceinline__ uint32_t tile_offset(int row, int c) {
  return (c >> 5) * ATOM + sw128_f32_offset(row, c & 31);
}

// A 64 x 64 block of a row-major source (row stride `ld` floats), split
// and stored as a K-major operand (rows as in the source) by all threads.
__device__ __forceinline__ void split_rows(const float* src, int64_t ld,
                                           unsigned char* hi,
                                           unsigned char* lo) {
  for (int idx = threadIdx.x; idx < TILE * TILE / 4; idx += THREADS) {
    const int row = idx >> 4, c = (idx & 15) * 4;
    float4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(src + row * ld + c), h, l);
    *reinterpret_cast<float4*>(hi + tile_offset(row, c)) = h;
    *reinterpret_cast<float4*>(lo + tile_offset(row, c)) = l;
  }
}

// Element (key j, column m) of a 64-key x 64-column source block, one
// warpgroup, four keys at a time: step i of warp w takes column group c =
// (w + 4 i) % 2 and keys 4 ((w + 4 i) / 2) .. + 3, lane l column m = 32 c
// + l; each load reads 128 contiguous bytes of one row, and each 16-byte
// store of the transposed tile (four keys of one row) is free of bank
// conflicts.
__device__ __forceinline__ void load_cols(float4 (&r)[8], const float* src,
                                          int64_t ld, int tw) {
  const int lane = tw & 31, warp = tw >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = warp + WG_WARPS * i;
    const float* s = src + (q >> 1) * 4 * ld + 32 * (q & 1) + lane;
    r[i] = make_float4(s[0], s[ld], s[2 * ld], s[3 * ld]);
  }
}

// ... times scale[j] when given, split and stored transposed: a K-major
// operand whose rows are the source's columns and whose K is the keys.
__device__ __forceinline__ void store_cols(const float4 (&r)[8],
                                           unsigned char* hi,
                                           unsigned char* lo,
                                           const float* scale, int tw) {
  const int lane = tw & 31, warp = tw >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = warp + WG_WARPS * i;
    const int j = (q >> 1) * 4, m = 32 * (q & 1) + lane;
    float4 x = r[i];
    if (scale != nullptr) {
      x.x *= scale[j];
      x.y *= scale[j + 1];
      x.z *= scale[j + 2];
      x.w *= scale[j + 3];
    }
    float4 h, l;
    split_tf32(x, h, l);
    *reinterpret_cast<float4*>(hi + tile_offset(m, j)) = h;
    *reinterpret_cast<float4*>(lo + tile_offset(m, j)) = l;
  }
}

// acc (+)= A B^T over 64 keys in 3xTF32: A and B are 64-row K-major tiles
// (hi and lo each) at shared-memory addresses.
__device__ __forceinline__ void mma_tile(float (&acc)[32], uint32_t a_hi,
                                         uint32_t a_lo, uint32_t b_hi,
                                         uint32_t b_lo, bool overwrite) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < TILE / 8; ++s) {
    const uint32_t off = (s >> 2) * ATOM + (s & 3) * 32;
    wgmma_tf32_n64(acc, desc_k_major(a_lo + off), desc_k_major(b_hi + off),
                   !(overwrite && s == 0));
    wgmma_tf32_n64(acc, desc_k_major(a_hi + off), desc_k_major(b_lo + off),
                   1);
    wgmma_tf32_n64(acc, desc_k_major(a_hi + off), desc_k_major(b_hi + off),
                   1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_array(acc);
}

// dt of head hh into dts, and dA_cum = cumsum(dt * a) in fp64 into cum
// (two elements a thread, warp shuffles, the warp totals in wsum); one
// warpgroup.
__device__ void scan_head(const Params& p, int64_t row0, int hh, int tw,
                          int wg, float* dts, double* cum, double* wsum) {
  const int lane = tw & 31, warp = tw >> 5;
  const int q = p.q;
  const float a = -expf(p.a_log[hh]);
  for (int i = tw; i < q; i += WG_THREADS)
    dts[i] = p.dt[(row0 + i) * p.h + hh];
  wg_sync(wg);
  const int e0 = 2 * tw, e1 = 2 * tw + 1;
  const double v0 = e0 < q ? double(dts[e0] * a) : 0.0;
  const double v1 = e1 < q ? double(dts[e1] * a) : 0.0;
  const double run = v0 + v1;
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  wg_sync(wg);
  double base = incl - run;
  for (int w = 0; w < warp; ++w) base += wsum[w];
  if (e0 < q) cum[e0] = base + v0;
  if (e1 < q) cum[e1] = base + v0 + v1;
  wg_sync(wg);
}

// W = S o L o dt_j for key tile jt, split and stored as the A tile: each
// thread four keys of a row at a time, S read back as float4.
__device__ __forceinline__ void build_w(const float* S, int jt, int i0,
                                        const double* cum, const float* dts,
                                        unsigned char* hi, unsigned char* lo,
                                        int tw) {
#pragma unroll 2
  for (int e = 0; e < 8; ++e) {
    const int idx = tw + WG_THREADS * e;
    const int r = idx >> 4, c = (idx & 15) * 4;
    const int gi = i0 + r, gj = jt * TILE + c;
    const float4 s = *reinterpret_cast<const float4*>(S + r * S_LD + gj);
    const float sv[4] = {s.x, s.y, s.z, s.w};
    const double ci = cum[gi];
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = gj + k <= gi
                 ? sv[k] * exp_fast(float(ci - cum[gj + k])) * dts[gj + k]
                 : 0.f;
    float4 h, l;
    split_tf32(make_float4(w[0], w[1], w[2], w[3]), h, l);
    *reinterpret_cast<float4*>(hi + tile_offset(r, c)) = h;
    *reinterpret_cast<float4*>(lo + tile_offset(r, c)) = l;
  }
}

// A 64 x 64 accumulator to a row-major destination (row stride ld).
__device__ __forceinline__ void store_acc(const float (&acc)[32], float* dst,
                                          int64_t ld, int tw) {
  const int lane = tw & 31, warp = tw >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + (lane >> 2) + 8 * half;
      const int c = 8 * i + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst + r * ld + c) =
          make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunk_wgmma_kernel(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sb0 = (raw + 1023u) & ~1023u;
  unsigned char* sm0 = smem_raw + (sb0 - raw);
  float* S = reinterpret_cast<float*>(sm0);
  auto stage = [&](int s) { return sm0 + S_BYTES + s * STAGE_BYTES; };
  auto stage_u32 = [&](int s) { return sb0 + S_BYTES + s * STAGE_BYTES; };
  auto full = [&](int s) { return sb0 + BAR_OFF + 8u * s; };
  auto empty = [&](int s) { return sb0 + BAR_OFF + 8u * (STAGES + s); };

  const int q = p.q, h = p.h;
  const int nt = q / TILE;
  // the query tiles of one (chunk, head group) are neighbours, the
  // heaviest (most key tiles) first
  const int it = nt - 1 - static_cast<int>(blockIdx.x % nt);
  const int rest = static_cast<int>(blockIdx.x / nt);
  const int hg = rest % p.groups, bc = rest / p.groups;
  const int i0 = it * TILE;
  const int64_t row0 = int64_t(bc) * q;        // first row of the chunk
  const int64_t ldx = int64_t(h) * WIDTH;      // row stride of x and y
  const int wg = warpgroup_index(), tw = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), WG_THREADS);     // every thread of its producer
      mbar_init(empty(s), WG_THREADS);    // every consumer thread
    }
    mbar_fence_init();
  }

  // ---- S = C_tile B^T for the key tiles up to the diagonal: every thread
  // splits, the consumer multiplies; S kept for all the CTA's heads -------
  split_rows(p.C + (row0 + i0) * WIDTH, WIDTH, stage(0) + A_HI,
             stage(0) + A_LO);
  for (int jt = 0; jt <= it; ++jt) {
    split_rows(p.B + (row0 + jt * TILE) * WIDTH, WIDTH, stage(0) + B_HI,
               stage(0) + B_LO);
    fence_proxy_async();
    __syncthreads();
    if (wg == 2) {
      float acc[32];
      const uint32_t st = stage_u32(0);
      mma_tile(acc, st + A_HI, st + A_LO, st + B_HI, st + B_LO, true);
      store_acc(acc, S + jt * TILE, S_LD, tw);
    }
    __syncthreads();
  }

  // ---- the work items: per head, the y tiles jt = 0..it, then (query
  // tile 0 only) the state's key tiles; item n goes through stage n % 2,
  // filled by producer n % 2 --------------------------------------------
  const int n_y = it + 1;
  const int per_head = n_y + (it == 0 ? nt : 0);
  const int h_first = hg * HEADS, h_end = min(h, h_first + HEADS);
  if (wg < 2) {
    unsigned char* sc = sm0 + SCAL_BASE + wg * SCAL_BYTES;
    float* dts = reinterpret_cast<float*>(sc + DT_OFF);
    double* cum = reinterpret_cast<double*>(sc + CUM_OFF);
    float* wj = reinterpret_cast<float*>(sc + WJ_OFF);
    double* wsum = reinterpret_cast<double*>(sc + WSUM_OFF);
    for (int hh = h_first; hh < h_end; ++hh) {
      scan_head(p, row0, hh, tw, wg, dts, cum, wsum);
      const float* xg = p.x + row0 * ldx + int64_t(hh) * WIDTH;
      if (it == 0) {
        const double last = cum[q - 1];
        for (int j = tw; j < q; j += WG_THREADS)
          wj[j] = dts[j] * expf(float(last - cum[j]));
        if (wg == 0 && tw == 0)
          p.chunk_lf[int64_t(bc) * h + hh] = float(last);
        wg_sync(wg);
      }
      const int n0 = (hh - h_first) * per_head;
      for (int k = (n0 + wg) & 1; k < per_head; k += 2) {
        const int n = n0 + k;          // n % 2 == wg
        if (n >= STAGES) mbar_wait(empty(wg), ((n >> 1) - 1) & 1);
        unsigned char* st = stage(wg);
        float4 xr[8];
        if (k < n_y) {                 // y tile k: A = W, B = X^T
          load_cols(xr, xg + k * TILE * ldx, ldx, tw);
          build_w(S, k, i0, cum, dts, st + A_HI, st + A_LO, tw);
          store_cols(xr, st + B_HI, st + B_LO, nullptr, tw);
        } else {                       // state key tile: A = B^T, B = xw^T
          const int kt = k - n_y;
          float4 br[8];
          load_cols(br, p.B + (row0 + kt * TILE) * WIDTH, WIDTH, tw);
          load_cols(xr, xg + kt * TILE * ldx, ldx, tw);
          store_cols(br, st + A_HI, st + A_LO, nullptr, tw);
          store_cols(xr, st + B_HI, st + B_LO, wj + kt * TILE, tw);
        }
        fence_proxy_async();
        mbar_arrive(full(wg));
      }
      wg_sync(wg);     // this head's dt, cum and wj are no longer read
    }
  } else {
    float acc[32];
    for (int hh = h_first; hh < h_end; ++hh) {
      const int n0 = (hh - h_first) * per_head;
      for (int k = 0; k < per_head; ++k) {
        const int n = n0 + k, s = n & 1;
        mbar_wait(full(s), (n >> 1) & 1);
        const uint32_t st = stage_u32(s);
        const bool first = k == 0 || k == n_y;
        mma_tile(acc, st + A_HI, st + A_LO, st + B_HI, st + B_LO, first);
        mbar_arrive(empty(s));
        if (k == n_y - 1)
          store_acc(acc, p.y + (row0 + i0) * ldx + int64_t(hh) * WIDTH, ldx,
                    tw);
        else if (k == per_head - 1)
          store_acc(acc, p.states + (int64_t(bc) * h + hh) * WIDTH * WIDTH,
                    WIDTH, tw);
      }
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Tensors are contiguous fp32,
// 16-byte aligned, in the shapes listed in Params; n_chunks = b * nc;
// n = p = 64 and q a multiple of 64 up to 256.  Returns the CUDA error
// code of the launch (0 on success); the kernel runs on `stream` and
// nothing is synchronised.
extern "C" int ssd_chunk_fwd_wgmma(const float* x, const float* dt,
                                   const float* a_log, const float* B,
                                   const float* C, float* y, float* states,
                                   float* chunk_lf, int n_chunks, int q,
                                   int h, int n, int pdim, void* stream) {
  if (n != WIDTH || pdim != WIDTH || q < TILE || q > MAX_Q || q % TILE ||
      h < 1 || n_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, a_log, B, C, y, states, chunk_lf, q, h,
           (h + HEADS - 1) / HEADS};
  const long long grid =
      static_cast<long long>(n_chunks) * p.groups * (q / TILE);
  if (grid >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_ALLOC);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_wgmma_kernel<<<static_cast<unsigned>(grid), THREADS, SMEM_ALLOC,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_chunk_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
