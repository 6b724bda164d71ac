// mLSTM (xLSTM matrix memory) intra-chunk kernel for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mlstm_scan/kernel.py:mlstm_chunk_pallas (body
// _mlstm_chunk_kernel).  Same function, per unit u = (batch, chunk, head),
// in fp32 (Q rows of the chunk, head dim P):
//
//   lf_cum    = cumsum(lf)                                      (Q)
//   dmat[i,j] = lf_cum[i] - lf_cum[j] + li[j]   (j <= i, else -1e30)
//   m_intra   = rowmax(dmat)                                    (Q)
//   W         = ((q * scale) k^T) o exp(dmat - m_intra)         (Q, Q)
//   y_intra   = W v,   n_intra = rowsum(W)                      (Q, P), (Q)
//   decay_end = lf_cum[Q-1] - lf_cum + li,   m_state = max(decay_end)
//   sk        = exp(decay_end - m_state)                        (Q)
//   state     = k^T (sk o v),   norm = sum_j sk[j] k[j]         (P, P), (P)
//   chunk_lf  = lf_cum[Q-1]
//
// The cross-chunk recurrence and the combine stay outside, in ops.py, as in
// the reference.  lf_cum is summed in fp64 and dmat, its row max, decay_end
// and m_state are fp64 until exp's argument is rounded to fp32; the plain
// twin (kernel.py:mlstm_chunk_plain) does the same, so the two differ only
// by the order of their fp32 sums.  Above the diagonal W is 0: the
// reference's finite -1e30 gives exp(-1e30 - m) = 0 there.  Rows of a
// ragged chunk carry li = -1e30 (ops.py pads so), which makes them 0 in W
// and in sk; every chunk keeps its first row real, so each row max stays
// finite.
//
// Why not the TPU's grid.  The TPU kernel runs one grid step per unit and
// holds q, k, v (Q x P) and the P x P state in VMEM.  At xlstm-1.3b's
// shapes (Q = 256, P = 1024) those are 1 MiB each in fp32, far beyond a
// CTA's 227 KB, and its 128 units (b 2, nc 16, h 4) would not fill 132
// SMs.  So the function is split into three launches of 64 x 64 output
// tiles, 256 threads each (16 x 16, a 4 x 4 micro-tile per thread, float4
// reads from shared memory), reducing in slices of 32 that are staged in
// shared memory:
//
//   pass 1, W:     one CTA per (unit, query tile, key tile <= query tile);
//                  q k^T reduced over P, then the decay and the row max
//                  applied; W goes to a (units, Qp, Qp) fp32 scratch (Qp = Q
//                  rounded up to 64; 33.5 MB at the full shape, which fits
//                  in the 50 MB L2); m_intra from the key tile 0 CTAs.
//   pass 2, W v:   one CTA per (unit, query tile, 64 columns of v); key
//                  tiles above the diagonal are never read; n_intra from
//                  the column-slice 0 CTAs.
//   pass 3, state: one CTA per (unit, 64 x 64 tile of the P x P state),
//                  streaming k and sk o v over the Q rows; norm from the
//                  column-tile 0 CTAs, chunk_lf and m_state from tile (0, 0).
//
// Bound.  At (b 2, S 4096, Q 256, h 4, P 1024) the function needs, per
// unit, 2P flops on each of the Q(Q+1)/2 = 32,896 kept pairs for q k^T and
// again for W v, 2 Q P^2 for the state and 2 Q P for the norm: 672 MFLOP,
// 86.0 GFLOP over 128 units, 1.284 ms at the fp32 peak of 67 TFLOP/s.  Its
// fp32 inputs and outputs are 1.075 GB (the states alone 537 MB), 0.321 ms
// at 3.35 TB/s.  So it is bound by operations (80 flops per byte), and the
// state (80% of the flops) is where the time goes.  This first version
// multiplies in fp32 on the CUDA cores; wgmma on tf32 or bf16 tiles, TMA
// loads and fusing the three passes come later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;            // output tile rows and columns
constexpr int BK = 32;              // reduction slice
constexpr int LD = TILE + 4;        // shared row stride, float4-aligned
constexpr int NTHREADS = 256;       // 16 x 16 threads
constexpr int WARPS = NTHREADS / 32;
constexpr int MAX_Q = NTHREADS;     // one chunk row per thread in the scan
constexpr int MAX_P = 1024;

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
  float* w;            // scratch (b * nc * h, Qp, Qp)
  int nq, h, pd, qp;  // chunk rows Q, heads, head dim P, Q rounded up to 64
  float scale;
};

// Offset of row r of unit u's chunk in a (b, nc, Q, h, width) tensor.
__device__ __forceinline__ int64_t row_offset(const Params& p, int u, int r,
                                              int width) {
  const int64_t bc = u / p.h;
  return ((bc * p.nq + r) * p.h + u % p.h) * int64_t(width);
}

// lf_cum (inclusive, fp64) and li of unit u's chunk into shared memory.
__device__ void load_cumsum(const Params& p, int u, double* cum,
                            float* li_s) {
  __shared__ double warp_sum[WARPS];
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
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    double s = lane < WARPS ? warp_sum[lane] : 0.0;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += up;
    }
    if (lane < WARPS) warp_sum[lane] = s;
  }
  __syncthreads();
  if (warp > 0) x += warp_sum[warp - 1];
  if (t < p.nq) cum[t] = x;
  __syncthreads();
}

// dst[kk][r] = src[(row0 + r) * stride + col0 + kk] * mul for a 64-row x
// BK-column block (rows >= nrows and columns >= ncols read as 0; ncols is a
// multiple of 4).
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                int64_t stride, int row0,
                                                int nrows, int col0,
                                                int ncols, float mul) {
  constexpr int V4 = BK / 4;
  for (int e = threadIdx.x; e < TILE * V4; e += NTHREADS) {
    const int r = e / V4, c = (e % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && col0 + c < ncols)
      x = *reinterpret_cast<const float4*>(src + (row0 + r) * stride +
                                           col0 + c);
    dst[(c + 0) * LD + r] = x.x * mul;
    dst[(c + 1) * LD + r] = x.y * mul;
    dst[(c + 2) * LD + r] = x.z * mul;
    dst[(c + 3) * LD + r] = x.w * mul;
  }
}

// dst[kk][c] = src[(row0 + kk) * stride + col0 + c] (* scale[kk] when
// given) for a BK-row x 64-column block (rows >= nrows and columns >= ncols
// read as 0; ncols is a multiple of 4).
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int row0, int nrows,
                                          int col0, int ncols,
                                          const float* scale) {
  constexpr int V4 = TILE / 4;
  for (int e = threadIdx.x; e < BK * V4; e += NTHREADS) {
    const int r = e / V4, c = (e % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && col0 + c < ncols) {
      x = *reinterpret_cast<const float4*>(src + (row0 + r) * stride +
                                           col0 + c);
      if (scale != nullptr) {
        const float s = scale[row0 + r];
        x.x *= s;
        x.y *= s;
        x.z *= s;
        x.w *= s;
      }
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// acc[a][b] += sum_kk A[kk][ty*4 + a] * B[kk][tx*4 + b] over one slice.
__device__ __forceinline__ void mma_slice(const float* A, const float* B,
                                          float (&acc)[4][4], int ty,
                                          int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(A + kk * LD + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(B + kk * LD + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---- pass 1: W = (q scale k^T) o exp(dmat - m_intra) --------------------
__global__ void __launch_bounds__(NTHREADS)
mlstm_w_kernel(const Params p) {
  __shared__ double cum[MAX_Q];
  __shared__ double m_row[TILE];
  __shared__ float li_s[MAX_Q];
  __shared__ __align__(16) float As[BK * LD];
  __shared__ __align__(16) float Bs[BK * LD];

  const int nt = p.qp / TILE;
  const int npairs = nt * (nt + 1) / 2;
  const int u = blockIdx.x / npairs;
  const int pr = blockIdx.x % npairs;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pr) ++it;
  const int jt = pr - it * (it + 1) / 2;
  const int i0 = it * TILE, j0 = jt * TILE;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;

  load_cumsum(p, u, cum, li_s);

  // row max of dmat for the tile's rows, four threads a row (fp64); the
  // -1e30 of the masked entries is the start value
  {
    const int r = t / 4, part = t % 4, i = i0 + r;
    double mx = -1e30;
    if (i < p.nq)
      for (int j = part; j <= i; j += 4)
        mx = fmax(mx, (cum[i] - cum[j]) + double(li_s[j]));
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (part == 0) m_row[r] = mx;
  }

  const int64_t stride = int64_t(p.h) * p.pd;
  const float* qg = p.q + row_offset(p, u, 0, p.pd);
  const float* kg = p.k + row_offset(p, u, 0, p.pd);
  float acc[4][4] = {};
  for (int d0 = 0; d0 < p.pd; d0 += BK) {
    __syncthreads();
    load_transposed(As, qg, stride, i0, p.nq, d0, p.pd, p.scale);
    load_transposed(Bs, kg, stride, j0, p.nq, d0, p.pd, 1.f);
    __syncthreads();
    mma_slice(As, Bs, acc, ty, tx);
  }

  float* wg = p.w + int64_t(u) * p.qp * p.qp;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    float out[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      out[b] = 0.f;
      if (i < p.nq && j <= i) {
        const double d = (cum[i] - cum[j]) + double(li_s[j]);
        out[b] = acc[a][b] * expf(float(d - m_row[ty * 4 + a]));
      }
    }
    *reinterpret_cast<float4*>(wg + int64_t(i) * p.qp + j0 + tx * 4) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
  if (jt == 0 && t < TILE && i0 + t < p.nq)
    p.m_intra[row_offset(p, u, i0 + t, 1)] = float(m_row[t]);
}

// ---- pass 2: y_intra = W v, n_intra = rowsum(W) --------------------------
__global__ void __launch_bounds__(NTHREADS)
mlstm_y_kernel(const Params p) {
  __shared__ __align__(16) float As[BK * LD];
  __shared__ __align__(16) float Bs[BK * LD];

  const int nt = p.qp / TILE;
  const int ncol = (p.pd + TILE - 1) / TILE;
  const int u = blockIdx.x / (nt * ncol);
  const int it = (blockIdx.x / ncol) % nt;
  const int ct = blockIdx.x % ncol;
  const int i0 = it * TILE, n0 = ct * TILE;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;

  const float* wg = p.w + int64_t(u) * p.qp * p.qp;
  const float* vg = p.v + row_offset(p, u, 0, p.pd);
  const int64_t stride = int64_t(p.h) * p.pd;
  const int jend = min(i0 + TILE, p.nq);     // key rows this tile sees
  float acc[4][4] = {};
  float rowsum = 0.f;
  for (int j0 = 0; j0 < jend; j0 += BK) {
    __syncthreads();
    // W columns in [Q, Qp) are 0 (above every real row's diagonal)
    load_transposed(As, wg, p.qp, i0, p.qp, j0, p.qp, 1.f);
    load_rows(Bs, vg, stride, j0, jend, n0, p.pd, nullptr);
    __syncthreads();
    if (ct == 0 && t < TILE)
      for (int kk = 0; kk < BK; ++kk) rowsum += As[kk * LD + t];
    mma_slice(As, Bs, acc, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a, n = n0 + tx * 4;
    if (i < p.nq && n < p.pd)
      *reinterpret_cast<float4*>(p.y + row_offset(p, u, i, p.pd) + n) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  if (ct == 0 && t < TILE && i0 + t < p.nq)
    p.n_intra[row_offset(p, u, i0 + t, 1)] = rowsum;
}

// ---- pass 3: state = k^T (sk o v), norm, chunk_lf, m_state ---------------
__global__ void __launch_bounds__(NTHREADS)
mlstm_state_kernel(const Params p) {
  __shared__ double cum[MAX_Q];
  __shared__ float li_s[MAX_Q];
  __shared__ float sk[MAX_Q];
  __shared__ double warp_max[WARPS];
  __shared__ __align__(16) float As[BK * LD];
  __shared__ __align__(16) float Bs[BK * LD];

  const int ntile = (p.pd + TILE - 1) / TILE;
  const int u = blockIdx.x / (ntile * ntile);
  const int mt = (blockIdx.x / ntile) % ntile;
  const int nt = blockIdx.x % ntile;
  const int m0 = mt * TILE, n0 = nt * TILE;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int lane = t % 32, warp = t / 32;

  load_cumsum(p, u, cum, li_s);
  const double last = cum[p.nq - 1];
  double de = -1.0e300;                         // decay_end of row t
  if (t < p.nq) de = (last - cum[t]) + double(li_s[t]);
  double mx = de;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) warp_max[warp] = mx;
  __syncthreads();
  double m_state = warp_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m_state = fmax(m_state, warp_max[w]);
  if (t < p.nq) sk[t] = expf(float(de - m_state));
  __syncthreads();

  const int64_t stride = int64_t(p.h) * p.pd;
  const float* kg = p.k + row_offset(p, u, 0, p.pd);
  const float* vg = p.v + row_offset(p, u, 0, p.pd);
  float acc[4][4] = {};
  float norm = 0.f;
  for (int j0 = 0; j0 < p.nq; j0 += BK) {
    __syncthreads();
    load_rows(As, kg, stride, j0, p.nq, m0, p.pd, nullptr);
    load_rows(Bs, vg, stride, j0, p.nq, n0, p.pd, sk);
    __syncthreads();
    if (nt == 0 && t < TILE)
      for (int kk = 0; kk < BK && j0 + kk < p.nq; ++kk)
        norm = fmaf(sk[j0 + kk], As[kk * LD + t], norm);
    mma_slice(As, Bs, acc, ty, tx);
  }

  float* sg = p.states + int64_t(u) * p.pd * p.pd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + ty * 4 + a, n = n0 + tx * 4;
    if (m < p.pd && n < p.pd)
      *reinterpret_cast<float4*>(sg + int64_t(m) * p.pd + n) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
  if (nt == 0 && t < TILE && m0 + t < p.pd)
    p.norms[int64_t(u) * p.pd + m0 + t] = norm;
  if (mt == 0 && nt == 0 && t == 0) {
    p.chunk_lf[u] = float(last);
    p.m_state[u] = float(m_state);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All tensors are contiguous fp32
// in the shapes listed in Params; units = b * nc * h; w is a scratch of
// units * qp * qp floats, qp = q rounded up to 64.  The three passes run in
// order on `stream`; nothing is synchronised.  Returns the CUDA error code
// of the first launch that failed (0 on success).
extern "C" int mlstm_chunk_fwd(const float* q, const float* k, const float* v,
                               const float* li, const float* lf, float* y,
                               float* n_intra, float* m_intra, float* states,
                               float* norms, float* chunk_lf, float* m_state,
                               float* w, int units, int nq, int h, int pd,
                               float scale, void* stream) {
  if (units < 1 || h < 1 || nq < 1 || nq > MAX_Q || pd < 16 || pd > MAX_P ||
      pd % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, li, lf, y, n_intra, m_intra, states, norms,
                 chunk_lf, m_state, w, nq, h, pd,
                 (nq + TILE - 1) / TILE * TILE, scale};
  const int64_t nt = p.qp / TILE, ntile = (pd + TILE - 1) / TILE;
  const int64_t grid[3] = {units * nt * (nt + 1) / 2, units * nt * ntile,
                           units * ntile * ntile};
  for (const int64_t g : grid)
    if (g >= (int64_t(1) << 31))
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlstm_w_kernel<<<unsigned(grid[0]), NTHREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_y_kernel<<<unsigned(grid[1]), NTHREADS, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_state_kernel<<<unsigned(grid[2]), NTHREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlstm_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
