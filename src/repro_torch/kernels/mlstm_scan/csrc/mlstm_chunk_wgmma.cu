// mLSTM (xLSTM matrix memory) intra-chunk kernel for Hopper (sm_90a):
// fp32-accurate products on the tf32 tensor cores through wgmma.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mlstm_scan/kernel.py:mlstm_chunk_pallas (body
// _mlstm_chunk_kernel) at head dims that are multiples of 128 (xlstm-1.3b:
// P = 1024) and chunks of 64..256 rows in whole 64-row tiles.  Same
// function as mlstm_chunk.cu, which stays for the other shapes (the
// wrapper's written rule, choose_variant in ../kernel.py), per unit u =
// (batch, chunk, head), in fp32:
//
//   lf_cum    = cumsum(lf)                        (Q, summed in fp64)
//   dmat[i,j] = lf_cum[i] - lf_cum[j] + li[j]     (j <= i, else -1e30)
//   m_intra   = rowmax(dmat)                      (fp64 until exp)
//   W         = ((q * scale) k^T) o exp(dmat - m_intra)
//   y_intra   = W v,   n_intra = rowsum(W)
//   decay_end = lf_cum[Q-1] - lf_cum + li,   m_state = max(decay_end)
//   sk        = exp(decay_end - m_state)
//   state     = k^T (sk o v),   norm = sum_j sk[j] k[j]
//   chunk_lf  = lf_cum[Q-1]
//
// Above the diagonal W is 0 (the reference's finite -1e30); rows of a
// ragged chunk carry li = -1e30 (ops.py pads so), which makes them 0 in W
// and sk, and every chunk keeps its first row real, so each row max and
// m_state stay finite.
//
// Bound.  At xlstm-1.3b's prefill shape (b 2, S 4096, Q 256, h 4, P 1024)
// the function needs 86.0 GFLOP (80% of it the P x P states) against
// 1.075 GB of fp32 inputs and outputs (the states alone 537 MB): 0.174 ms
// at the tf32 tensor-core peak, 0.321 ms at 3.35 TB/s, so bound by bytes.
// The three tf32 passes below make the tensor work 258 GFLOP, 0.52 ms,
// which is more than the bytes' time.
//
// Accuracy: 3xTF32, as in ssd_chunk_wgmma.cu: every operand split a = hi
// + lo (hopper.cuh: split_tf32), each product lo_a hi_b + hi_a lo_b +
// hi_a hi_b in one fp32 accumulator; one tf32 pass misses the kernel
// tests' 1e-4 by 50x at the path shape (tools/kernel_ablation.py,
// single_tf32; the CPU emulation in tests/test_torch_split_precision.py
// shows it too).  Worst error against the twin on an H100: 1.3e-4
// absolute over chip_smoke.py's cases, 0.51 of the tolerance at the path
// shape (tools/kernel_ablation.py).  q k^T has both operands
// K-major as stored; v (in W v), and k and sk o v (in the state) have the
// keys, their reduction axis, as their row axis, and wgmma reads .tf32
// only K-major, so those tiles are transposed on their way into shared
// memory: loaded by the threads (128-byte rows), split in registers and
// stored as 16-byte chunks of four keys in the 128-byte swizzle.
//
// Design: two kernels behind one entry point (one launch in the wrapper's
// count); the old kernel's W scratch in device memory (33.5 MB) is gone.
//  * y: one CTA of two warpgroups per (unit, 64-row query tile), 512 CTAs,
//    the four query tiles of a unit next to each other so k and v are
//    read from L2 by the later ones.  The diagonal makes the work uneven
//    (1 to 4 key tiles); the grid is four times the SM count and no CTA
//    holds more than 4 of a unit's 10 key tiles, so the uneven CTAs even
//    out across the SMs.  (a) S = (q scale) k^T over P in
//    32-column atoms, the key tiles dealt to the two warpgroups in turn,
//    S in registers; (b) the decay and the row max applied in registers,
//    W split into shared memory (64 x 256, hi and lo: 128 KB), n_intra
//    from W's row sums; (c) y = W v, v streamed in 128-column slices,
//    each warpgroup 64 of them, over the key tiles up to the diagonal.
//  * state: one CTA of two warpgroups per (unit, 128 x 128 tile of the
//    P x P state), 8,192 CTAs, the tiles of a unit next to each other;
//    k and sk o v streamed over the Q keys in 32-key atoms, split and
//    stored transposed by all threads, each warpgroup one m64n128
//    accumulator; two CTAs an SM, so one's stores overlap the other's
//    wgmmas.  The norm is summed from the k values the column-tile-0 CTAs
//    hold anyway.  Alternatives measured slower at the path shape on an
//    H100 80GB HBM3 at 700 W: two stages in one CTA (one CTA an SM); k^T
//    straight into the registers of a register-A wgmma (it spills at two
//    CTAs an SM); one or two producer warpgroups feeding two consumer
//    warpgroups through a three-stage mbarrier ring.
// In both kernels the next tile's global loads are issued into registers
// before the current tile's wgmmas and stored after them.  At the path
// shape the pair takes 1.51 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py), 0.21 of the bound, most of it the state: its three
// passes alone are 0.42 ms of tensor time, and every one of its operand
// bytes is split and stored by the threads and read three times by the
// wgmmas.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;             // query rows, key rows
constexpr int THREADS = 256;         // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 256;
constexpr int SLICE = 128;           // v columns per y step; state tile
constexpr int ATOM64 = 64 * 128;     // 64 rows x 32 fp32, bytes
constexpr int ATOM128 = 128 * 128;   // 128 rows x 32 fp32, bytes

// y kernel shared memory: W (64 rows x 256 keys, hi and lo), the v tile
// (128 columns x 64 keys, hi and lo), then the scalars.  The S phase
// stages its q atom and k atoms inside W's space.
constexpr int W_HI = 0, W_LO = 8 * ATOM64;
constexpr int V_HI = 16 * ATOM64, V_LO = V_HI + 2 * ATOM128;
constexpr int Q_HI = 0, Q_LO = ATOM64, K_HI = 2 * ATOM64,
              K_LO = K_HI + 4 * ATOM64;
constexpr int Y_CUM = V_LO + 2 * ATOM128;
constexpr int Y_LI = Y_CUM + MAX_Q * 8;
constexpr int Y_MROW = Y_LI + MAX_Q * 4;
constexpr int Y_NSUM = Y_MROW + TILE * 8;
constexpr int Y_WSUM = Y_NSUM + 2 * TILE * 4;
constexpr int Y_SMEM = Y_WSUM + WARPS * 8 + 1024;

// state kernel shared memory: the A = k^T and B = (sk o v)^T atoms (128
// rows x 32 keys, hi and lo), then the scalars.
constexpr int A_HI = 0, A_LO = ATOM128, B_HI = 2 * ATOM128,
              B_LO = 3 * ATOM128;
constexpr int S_CUM = 4 * ATOM128;
constexpr int S_LI = S_CUM + MAX_Q * 8;
constexpr int S_SK = S_LI + MAX_Q * 4;
constexpr int S_PART = S_SK + MAX_Q * 4;
constexpr int S_WSUM = S_PART + THREADS * 4;
constexpr int S_SMEM = S_WSUM + WARPS * 8 + 1024;

struct Params {
  const float* q;      // (b, nc, Q, h, P)
  const float* k;      // (b, nc, Q, h, P)
  const float* v;      // (b, nc, Q, h, P)
  const float* li;     // (b, nc, Q, h)
  const float* lf;     // (b, nc, Q, h)
  float* y;            // (b, nc, Q, h, P)
  float* n_intra;      // (b, nc, Q, h)
  float* m_intra;      // (b, nc, Q, h)
  float* states;       // (b, nc, h, P, P)
  float* norms;        // (b, nc, h, P)
  float* chunk_lf;     // (b, nc, h)
  float* m_state;      // (b, nc, h)
  int units, nq, h, pd;
  float scale;
};

// Offset of row r of unit u's chunk in a (b, nc, Q, h, width) tensor.
__device__ __forceinline__ int64_t row_offset(const Params& p, int u, int r,
                                              int width) {
  const int64_t bc = u / p.h;
  return ((bc * p.nq + r) * p.h + u % p.h) * int64_t(width);
}

__device__ __forceinline__ uint8_t* smem_base(uint32_t& sb) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  sb = (raw + 1023u) & ~1023u;
  return smem_raw + (sb - raw);
}

// lf_cum (inclusive, fp64) and li of unit u's chunk into shared memory,
// one row a thread.
__device__ void load_cumsum(const Params& p, int u, double* cum, float* li_s,
                            double* wsum) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  double x = 0.0;
  if (t < p.nq) {
    const int64_t i = row_offset(p, u, t, 1);
    x = double(p.lf[i]);
    li_s[t] = p.li[i];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += up;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += wsum[w];
  if (t < p.nq) cum[t] = x;
  __syncthreads();
}

// A 32-column atom of `rows` rows of a row-major source, 16 bytes a
// thread and step: element e of this thread is row (threadIdx.x + 256 e)
// / 8, columns 4 ((threadIdx.x + 256 e) % 8) onwards.
template <int N4>
__device__ __forceinline__ void load_atom(float4 (&r)[N4], const float* src,
                                          int64_t ld, int rows) {
#pragma unroll
  for (int e = 0; e < N4; ++e) {
    const int idx = threadIdx.x + THREADS * e;
    const int row = idx >> 3, c = (idx & 7) * 4;
    if (row < rows)
      r[e] = *reinterpret_cast<const float4*>(src + row * ld + c);
  }
}

// ... times mul, split and stored as one K-major atom (rows as in the
// source).
template <int N4>
__device__ __forceinline__ void store_atom(const float4 (&r)[N4], uint8_t* hi,
                                           uint8_t* lo, int rows, float mul) {
#pragma unroll
  for (int e = 0; e < N4; ++e) {
    const int idx = threadIdx.x + THREADS * e;
    const int row = idx >> 3, c = (idx & 7) * 4;
    if (row < rows) {
      const float4 a = make_float4(r[e].x * mul, r[e].y * mul, r[e].z * mul,
                                   r[e].w * mul);
      float4 h, l;
      split_tf32(a, h, l);
      const uint32_t off = sw128_f32_offset(row, c);
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  }
}

// Element (key j, column m) of a KEYS x 128 source block, four keys at a
// time: step i of warp w takes column group c = (w + 8 i) % 4 and keys
// 4 ((w + 8 i) / 4) .. + 3, lane l column m = 32 c + l; each load reads
// 128 contiguous bytes of one row, and each 16-byte store of the
// transposed tile (four keys of one row) is free of bank conflicts.
template <int KEYS>
__device__ __forceinline__ void load_cols(float4 (&r)[KEYS / 8],
                                          const float* src, int64_t ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < KEYS / 8; ++i) {
    const int q = warp + WARPS * i;
    const float* s = src + (q >> 2) * 4 * ld + 32 * (q & 3) + lane;
    r[i] = make_float4(s[0], s[ld], s[2 * ld], s[3 * ld]);
  }
}

// ... times scale[j] when given, split and stored transposed: 128 rows
// (the source's columns), K = the keys, in KEYS / 32 atoms.
template <int KEYS>
__device__ __forceinline__ void store_cols(const float4 (&r)[KEYS / 8],
                                           uint8_t* hi, uint8_t* lo,
                                           const float* scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < KEYS / 8; ++i) {
    const int q = warp + WARPS * i;
    const int j = (q >> 2) * 4, m = 32 * (q & 3) + lane;
    float4 x = r[i];
    if (scale != nullptr) {
      x.x *= scale[j];
      x.y *= scale[j + 1];
      x.z *= scale[j + 2];
      x.w *= scale[j + 3];
    }
    float4 h, l;
    split_tf32(x, h, l);
    const uint32_t off = (j >> 5) * ATOM128 + sw128_f32_offset(m, j & 31);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// acc (+)= A B^T over one 8-column step in 3xTF32 (descriptors of hi and
// lo at the step's address), N = 64.
__device__ __forceinline__ void mma3(float (&acc)[32], uint32_t a_hi,
                                     uint32_t a_lo, uint32_t b_hi,
                                     uint32_t b_lo, int accumulate) {
  wgmma_tf32_n64(acc, desc_k_major(a_lo), desc_k_major(b_hi), accumulate);
  wgmma_tf32_n64(acc, desc_k_major(a_hi), desc_k_major(b_lo), 1);
  wgmma_tf32_n64(acc, desc_k_major(a_hi), desc_k_major(b_hi), 1);
}

// ---------------------------------------------------------------------------
// y_intra, n_intra, m_intra
// ---------------------------------------------------------------------------

template <int NT>
__device__ void y_tile(const Params& p, int u, uint8_t* sm, uint32_t sb) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wg = warpgroup_index(), wq = warp & 3;          // warpgroup, its warp
  const int i0 = (NT - 1) * TILE;
  double* cum = reinterpret_cast<double*>(sm + Y_CUM);
  float* li_s = reinterpret_cast<float*>(sm + Y_LI);
  double* m_row = reinterpret_cast<double*>(sm + Y_MROW);
  float* nsum = reinterpret_cast<float*>(sm + Y_NSUM);
  double* wsum = reinterpret_cast<double*>(sm + Y_WSUM);

  load_cumsum(p, u, cum, li_s, wsum);
  // row max of dmat for the tile's rows, four threads a row (fp64); the
  // -1e30 of the masked entries is the start value
  {
    const int r = t / 4, part = t % 4, i = i0 + r;
    double mx = -1e30;
    for (int j = part; j <= i; j += 4)
      mx = fmax(mx, (cum[i] - cum[j]) + double(li_s[j]));
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (part == 0) m_row[r] = mx;
  }

  const int64_t ld = int64_t(p.h) * p.pd;        // row stride of q, k, v, y
  const float* qg = p.q + row_offset(p, u, i0, p.pd);
  const float* kg = p.k + row_offset(p, u, 0, p.pd);
  const float* vg = p.v + row_offset(p, u, 0, p.pd);

  // ---- S = (q scale) k^T; key tiles jt = wg, wg + 2 to this warpgroup ---
  constexpr int KROWS = NT * TILE;
  constexpr int K4 = (KROWS * 8 + THREADS - 1) / THREADS;   // float4 each
  float S[2][32];
  {
    float4 qr[2], kr[K4];
    load_atom(qr, qg, ld, TILE);
    load_atom(kr, kg, ld, KROWS);
    const int natoms = p.pd / 32;
    for (int a = 0; a < natoms; ++a) {
      store_atom(qr, sm + Q_HI, sm + Q_LO, TILE, p.scale);
      store_atom(kr, sm + K_HI, sm + K_LO, KROWS, 1.f);
      fence_proxy_async();
      __syncthreads();
      if (a + 1 < natoms) {
        load_atom(qr, qg + (a + 1) * 32, ld, TILE);
        load_atom(kr, kg + (a + 1) * 32, ld, KROWS);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const int jt = wg + 2 * tt;
          if (jt < NT)
            mma3(S[tt], sb + Q_HI + s * 32, sb + Q_LO + s * 32,
                     sb + K_HI + jt * ATOM64 + s * 32,
                     sb + K_LO + jt * ATOM64 + s * 32, a > 0 || s > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_array(S[0]);
      fence_array(S[1]);
      __syncthreads();
    }
  }

  // ---- W = S o exp(dmat - m), split into shared memory; n_intra ---------
  {
    float rs[2] = {0.f, 0.f};                    // rows lo, hi
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      const int jt = wg + 2 * tt;
      if (jt >= NT) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wq + (lane >> 2) + 8 * half;
          const int c = 8 * i + 2 * (lane & 3);
          const int gi = i0 + r, gj = jt * TILE + c;
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            w[e] = 0.f;
            if (gj + e <= gi) {
              const double d = (cum[gi] - cum[gj + e]) + double(li_s[gj + e]);
              w[e] = S[tt][4 * i + 2 * half + e] * expf(float(d - m_row[r]));
            }
          }
          rs[half] += w[0] + w[1];
          float2 h, l;
          split_tf32(w[0], h.x, l.x);
          split_tf32(w[1], h.y, l.y);
          const uint32_t off = (gj >> 5) * ATOM64 +
                               sw128_f32_offset(r, gj & 31);
          *reinterpret_cast<float2*>(sm + W_HI + off) = h;
          *reinterpret_cast<float2*>(sm + W_LO + off) = l;
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = rs[half];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) nsum[wg * TILE + 16 * wq + (lane >> 2) + 8 * half] = v;
    }
  }

  // ---- y = W v: 128-column slices of v, each warpgroup 64 of them -------
  const int nslices = p.pd / SLICE;
  const int steps = nslices * NT;
  float4 vr[TILE / 8];
  load_cols<TILE>(vr, vg, ld);
  float acc[32];
  for (int st = 0; st < steps; ++st) {
    const int sl = st / NT, jt = st % NT;
    store_cols<TILE>(vr, sm + V_HI, sm + V_LO, nullptr);
    fence_proxy_async();
    __syncthreads();
    if (st + 1 < steps) {
      const int sl1 = (st + 1) / NT, jt1 = (st + 1) % NT;
      load_cols<TILE>(vr, vg + jt1 * TILE * ld + sl1 * SLICE, ld);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TILE / 8; ++s) {
      const uint32_t wa = (2 * jt + (s >> 2)) * ATOM64 + (s & 3) * 32;
      const uint32_t va = (s >> 2) * ATOM128 + wg * ATOM64 + (s & 3) * 32;
      mma3(acc, sb + W_HI + wa, sb + W_LO + wa, sb + V_HI + va,
               sb + V_LO + va, jt > 0 || s > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_array(acc);
    __syncthreads();
    if (jt == NT - 1) {
      float* yg = p.y + row_offset(p, u, i0, p.pd) + sl * SLICE + wg * 64;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * wq + (lane >> 2) + 8 * half;
          const int c = 8 * i + 2 * (lane & 3);
          *reinterpret_cast<float2*>(yg + r * ld + c) =
              make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
        }
    }
  }

  if (t < TILE) {
    const int64_t o = row_offset(p, u, i0 + t, 1);
    p.n_intra[o] = nsum[t] + (NT > 1 ? nsum[TILE + t] : 0.f);
    p.m_intra[o] = float(m_row[t]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mlstm_y_wgmma_kernel(const Params p) {
  uint32_t sb;
  uint8_t* sm = smem_base(sb);
  const int nt = p.nq / TILE;
  // the query tiles of a unit are neighbours, the heaviest first
  const int u = static_cast<int>(blockIdx.x / nt);
  switch (nt - 1 - static_cast<int>(blockIdx.x % nt)) {
    case 0: y_tile<1>(p, u, sm, sb); break;
    case 1: y_tile<2>(p, u, sm, sb); break;
    case 2: y_tile<3>(p, u, sm, sb); break;
    default: y_tile<4>(p, u, sm, sb); break;
  }
}

// ---------------------------------------------------------------------------
// state = k^T (sk o v), norm, chunk_lf, m_state
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2)
    mlstm_state_wgmma_kernel(const Params p) {
  uint32_t sb;
  uint8_t* sm = smem_base(sb);
  double* cum = reinterpret_cast<double*>(sm + S_CUM);
  float* li_s = reinterpret_cast<float*>(sm + S_LI);
  float* sk = reinterpret_cast<float*>(sm + S_SK);
  float* part = reinterpret_cast<float*>(sm + S_PART);
  double* wsum = reinterpret_cast<double*>(sm + S_WSUM);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wg = warpgroup_index(), wq = warp & 3;
  const int ntile = p.pd / SLICE;
  const int u = static_cast<int>(blockIdx.x / (ntile * ntile));
  const int mt = static_cast<int>(blockIdx.x / ntile) % ntile;
  const int nt = static_cast<int>(blockIdx.x % ntile);
  const int m0 = mt * SLICE, n0 = nt * SLICE;

  load_cumsum(p, u, cum, li_s, wsum);
  const double last = cum[p.nq - 1];
  double de = -1.0e300;                          // decay_end of row t
  if (t < p.nq) de = (last - cum[t]) + double(li_s[t]);
  double mx = de;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  __syncthreads();                               // wsum's readers are done
  if (lane == 0) wsum[warp] = mx;
  __syncthreads();
  double m_state = wsum[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m_state = fmax(m_state, wsum[w]);
  if (t < p.nq) sk[t] = expf(float(de - m_state));
  __syncthreads();

  const int64_t ld = int64_t(p.h) * p.pd;
  const float* kg = p.k + row_offset(p, u, 0, p.pd) + m0;
  const float* vg = p.v + row_offset(p, u, 0, p.pd) + n0;
  const int natoms = p.nq / 32;
  float4 kr[4], vr[4];
  load_cols<32>(kr, kg, ld);
  load_cols<32>(vr, vg, ld);
  float acc[64];
  float norm = 0.f;     // column 32 (warp % 4) + lane, this warp's keys
  for (int a = 0; a < natoms; ++a) {
    if (nt == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* s = sk + a * 32 + ((warp + WARPS * i) >> 2) * 4;
        norm = fmaf(s[3], kr[i].w, fmaf(s[2], kr[i].z,
               fmaf(s[1], kr[i].y, fmaf(s[0], kr[i].x, norm))));
      }
    }
    store_cols<32>(kr, sm + A_HI, sm + A_LO, nullptr);
    store_cols<32>(vr, sm + B_HI, sm + B_LO, sk + a * 32);
    fence_proxy_async();
    __syncthreads();
    if (a + 1 < natoms) {
      load_cols<32>(kr, kg + (a + 1) * 32 * ld, ld);
      load_cols<32>(vr, vg + (a + 1) * 32 * ld, ld);
    }
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      const uint32_t a_off = wg * ATOM64 + k8 * 32, b_off = k8 * 32;
      wgmma_tf32_n128(acc, desc_k_major(sb + A_LO + a_off),
                      desc_k_major(sb + B_HI + b_off), a > 0 || k8 > 0);
      wgmma_tf32_n128(acc, desc_k_major(sb + A_HI + a_off),
                      desc_k_major(sb + B_LO + b_off), 1);
      wgmma_tf32_n128(acc, desc_k_major(sb + A_HI + a_off),
                      desc_k_major(sb + B_HI + b_off), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_array(acc);
    __syncthreads();
  }

  float* sg = p.states + (int64_t(u) * p.pd + m0 + wg * 64) * p.pd + n0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wq + (lane >> 2) + 8 * half;
      const int c = 8 * i + 2 * (lane & 3);
      *reinterpret_cast<float2*>(sg + int64_t(r) * p.pd + c) =
          make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  if (nt == 0) {          // warps w and w + 4 hold halves of one column's
    part[t] = norm;       // keys
    __syncthreads();
    if (t < SLICE)
      p.norms[int64_t(u) * p.pd + m0 + t] = part[t] + part[t + SLICE];
  }
  if (mt == 0 && nt == 0 && t == 0) {
    p.chunk_lf[u] = float(last);
    p.m_state[u] = float(m_state);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All tensors are contiguous fp32
// in the shapes listed in Params, 16-byte aligned; units = b * nc * h; nq a
// multiple of 64 up to 256; pd a multiple of 128.  The y and the state
// kernels run in order on `stream`; nothing is synchronised.  Returns the
// CUDA error code of the first launch that failed (0 on success).
extern "C" int mlstm_chunk_fwd_wgmma(const float* q, const float* k,
                                     const float* v, const float* li,
                                     const float* lf, float* y,
                                     float* n_intra, float* m_intra,
                                     float* states, float* norms,
                                     float* chunk_lf, float* m_state,
                                     int units, int nq, int h, int pd,
                                     float scale, void* stream) {
  if (units < 1 || h < 1 || nq < TILE || nq > MAX_Q || nq % TILE ||
      pd < SLICE || pd % SLICE)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,      k,      v,        li,      lf,
                 y,      n_intra, m_intra, states,  norms,
                 chunk_lf, m_state, units, nq, h, pd, scale};
  const int64_t ntile = pd / SLICE;
  const int64_t grid[2] = {int64_t(units) * (nq / TILE),
                           int64_t(units) * ntile * ntile};
  for (const int64_t g : grid)
    if (g >= (int64_t(1) << 31))
      return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_y_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Y_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mlstm_state_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlstm_y_wgmma_kernel<<<unsigned(grid[0]), THREADS, Y_SMEM, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_state_wgmma_kernel<<<unsigned(grid[1]), THREADS, S_SMEM, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlstm_chunk_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
