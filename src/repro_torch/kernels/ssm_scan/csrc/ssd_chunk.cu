// SSD (mamba2) intra-chunk scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssm_scan/kernel.py:ssd_chunk_pallas (body
// _ssd_chunk_kernel).  Same function, per (batch, chunk, head), in fp32:
//
//   dA      = dt * (-exp(A_log))                 (Q)
//   dA_cum  = cumsum(dA)                          (Q)
//   L[i,j]  = exp(dA_cum[i] - dA_cum[j]) if i >= j, else 0
//   y_diag  = ((C B^T) o L o dt_j) X              (Q, P)
//   states  = B^T (dt o exp(dA_cum[Q-1] - dA_cum) o X)   (N, P)
//   chunk_lf = dA_cum[Q-1]
//
// The inter-chunk recurrence stays outside, in ops.py, as in the
// reference.  L is computed under a select, never as exp(.) * mask: above
// the diagonal exp(dA_cum[i] - dA_cum[j]) overflows, and inf * 0 is NaN.
// dA_cum is summed in fp64 (the products dt * a stay fp32) and each
// difference dA_cum[i] - dA_cum[j] is taken in fp64 before it is rounded to
// fp32: at Q = 256 |dA_cum| reaches the hundreds, where an fp32 running sum
// carries ~1e-4 of rounding into L next to the diagonal, and two fp32 sums
// in different orders would disagree beyond the tests' 1e-4.  The plain
// twin (kernel.py:log_decay) sums in fp64 too.
//
// Design.  One CTA of 256 threads per (batch, chunk, head).  dt is staged
// in shared memory and dA is scanned there in fp64 (each thread sums 4
// elements, warps scan with shuffles, one warp scans the warp totals).  The
// TPU kernel holds the whole (Q, Q) tile in VMEM; at Q = 256 that is 256 KiB of
// fp32, more than a CTA's 227 KB, so the query rows go in tiles of 64 and,
// for each, the key rows in tiles of 64 up to the diagonal (tiles above it
// are never visited): S = C_tile B_tile^T (a 16 x 16 thread grid, a 4 x 4
// micro-tile each), W = S o L o dt_j written to shared memory, then
// acc += W X_tile with the 64 x P output tile in registers.  The state
// B^T (w o X) streams B and X once more in 64-row tiles, the N x P result
// in registers.  Shared memory at N = P = 64, Q = 256: four 64-row tiles
// (C, B, X, W) padded by one float per row so column reads hit distinct
// banks, plus dt and the fp64 dA_cum: 69,632 bytes, three CTAs per SM.
//
// Bound.  At zamba2-7b's shapes (b 2, S 4096, Q 256, h 112, P = N = 64) the
// function needs, on the kept pairs of the causal mask, 2N flops each for
// C B^T once per (batch, chunk) and 2P each for the product with X once
// per head, plus 2 Q N P per head for the state: 22.7 GFLOP, against
// 536 MB of fp32 inputs and outputs.  That is 42 flops per byte, above the
// fp32 CUDA-core balance (67 TFLOP/s over 3.35 TB/s = 20), so the function
// is bound by operations.  This first version multiplies in fp32 on the
// CUDA cores.  Heads share B and C (one group), yet every head's CTA
// recomputes C B^T, as the TPU kernel does (37.7 GFLOP done in all over
// 3,584 CTAs): sharing that tile across the heads of a chunk is the first
// saving a later version can make; wgmma (tf32 or bf16) and TMA loads come
// after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // query rows and key rows per tile
constexpr int NTHREADS = 256;     // 16 x 16 thread grid
constexpr int ROWS = TILE / 16;   // tile rows per thread
constexpr int WARPS = NTHREADS / 32;
constexpr int PER_THREAD = 4;     // dA elements each thread scans
constexpr int MAX_Q = PER_THREAD * NTHREADS;

struct Params {
  const float* x;      // (b, nc, Q, h, P)
  const float* dt;     // (b, nc, Q, h)
  const float* a_log;  // (h)
  const float* B;      // (b, nc, Q, N)
  const float* C;      // (b, nc, Q, N)
  float* y;            // (b, nc, Q, h, P)
  float* states;       // (b, nc, h, N, P)
  float* chunk_lf;     // (b, nc, h)
  int q, h;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int N, int P>
size_t smem_bytes(int q) {
  const int q_pad = round_up(q, TILE);
  return size_t(q_pad) * sizeof(double) +
         (size_t(TILE) * (N + 1) * 2 + size_t(TILE) * (P + 1) +
          size_t(TILE) * (TILE + 1) + size_t(q_pad)) * sizeof(float);
}

// Rows [row0, row0 + TILE) of a (Q, W) slice with row stride `stride`
// into a tile with row stride W + 1; rows at or past q are zero.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int row0, int q) {
  for (int i = threadIdx.x; i < TILE * W; i += NTHREADS) {
    const int r = i / W, c = i % W;
    const int s = row0 + r;
    dst[r * (W + 1) + c] = s < q ? src[s * stride + c] : 0.f;
  }
}

template <int N, int P>
__global__ void __launch_bounds__(NTHREADS)
ssd_chunk_kernel(const Params p) {
  static_assert(N % 16 == 0 && P % 16 == 0, "N and P: multiples of 16");
  constexpr int LDN = N + 1, LDP = P + 1, LDW = TILE + 1;
  constexpr int PCOLS = P / 16;   // output columns per thread
  constexpr int NROWS = N / 16;   // state rows per thread

  const int q = p.q, h = p.h;
  const int q_pad = (q + TILE - 1) / TILE * TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);   // q_pad
  float* Cs = reinterpret_cast<float*>(cum + q_pad);   // TILE x LDN
  float* Bs = Cs + TILE * LDN;      // TILE x LDN
  float* Xs = Bs + TILE * LDN;      // TILE x LDP
  float* Ws = Xs + TILE * LDP;      // TILE x LDW
  float* dts = Ws + TILE * LDW;     // q_pad
  __shared__ double warp_sum[WARPS];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int hh = blockIdx.x % h;
  const int64_t bc = blockIdx.x / h;          // batch * nc + chunk
  const int64_t row0 = bc * q;                // first row of the chunk

  const float* xg = p.x + (row0 * h + hh) * P;     // row stride h * P
  const float* dtg = p.dt + row0 * h + hh;         // row stride h
  const float* Bg = p.B + row0 * N;
  const float* Cg = p.C + row0 * N;
  float* yg = p.y + (row0 * h + hh) * P;

  // ---- dt and the inclusive fp64 scan of dA = dt * a ----------------------
  const float a = -expf(p.a_log[hh]);
  for (int i = tid; i < q_pad; i += NTHREADS)
    dts[i] = i < q ? dtg[int64_t(i) * h] : 0.f;
  __syncthreads();
  double part[PER_THREAD];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = tid * PER_THREAD + e;
    if (i < q) run += double(dts[i] * a);
    part[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double w = lane < WARPS ? warp_sum[lane] : 0.0;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    if (lane < WARPS) warp_sum[lane] = w;
  }
  __syncthreads();
  const double base = (incl - run) + (warp > 0 ? warp_sum[warp - 1] : 0.0);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = tid * PER_THREAD + e;
    if (i < q_pad) cum[i] = i < q ? base + part[e] : 0.0;
  }
  __syncthreads();

  // ---- y_diag: query tiles x key tiles up to the diagonal -----------------
  for (int i0 = 0; i0 < q; i0 += TILE) {
    __syncthreads();  // the previous tile's reads of Cs are done
    load_rows<N>(Cs, Cg, N, i0, q);
    float acc[ROWS][PCOLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < PCOLS; ++c) acc[r][c] = 0.f;

    for (int j0 = 0; j0 <= i0; j0 += TILE) {
      __syncthreads();  // the previous key tile's reads are done
      load_rows<N>(Bs, Bg, N, j0, q);
      load_rows<P>(Xs, xg, int64_t(h) * P, j0, q);
      __syncthreads();

      float s[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
      for (int k = 0; k < N; ++k) {
        float cv[ROWS], bv[4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) cv[r] = Cs[(ty * ROWS + r) * LDN + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * LDN + k];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + ty * ROWS + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          float w = 0.f;
          if (j <= i && i < q)
            w = s[r][c] * expf(float(cum[i] - cum[j])) * dts[j];
          Ws[(ty * ROWS + r) * LDW + tx + 16 * c] = w;
        }
      }
      __syncthreads();  // W is complete

#pragma unroll 4
      for (int jj = 0; jj < TILE; ++jj) {
        float wv[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) wv[r] = Ws[(ty * ROWS + r) * LDW + jj];
#pragma unroll
        for (int c = 0; c < PCOLS; ++c) {
          const float xv = Xs[jj * LDP + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][c] = fmaf(wv[r], xv, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + ty * ROWS + r;
      if (i >= q) continue;
#pragma unroll
      for (int c = 0; c < PCOLS; ++c)
        yg[int64_t(i) * h * P + tx + 16 * c] = acc[r][c];
    }
  }

  // ---- chunk state B^T (dt o exp(cum_last - cum) o X) ---------------------
  const double cum_last = cum[q - 1];
  float st[NROWS][PCOLS];
#pragma unroll
  for (int r = 0; r < NROWS; ++r)
#pragma unroll
    for (int c = 0; c < PCOLS; ++c) st[r][c] = 0.f;
  for (int j0 = 0; j0 < q; j0 += TILE) {
    __syncthreads();
    load_rows<N>(Bs, Bg, N, j0, q);
    load_rows<P>(Xs, xg, int64_t(h) * P, j0, q);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < TILE; ++jj) {
      const int j = j0 + jj;
      const float wj = j < q ? dts[j] * expf(float(cum_last - cum[j])) : 0.f;
      float bv[NROWS];
#pragma unroll
      for (int r = 0; r < NROWS; ++r) bv[r] = Bs[jj * LDN + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < PCOLS; ++c) {
        const float xv = Xs[jj * LDP + tx + 16 * c] * wj;
#pragma unroll
        for (int r = 0; r < NROWS; ++r) st[r][c] = fmaf(bv[r], xv, st[r][c]);
      }
    }
  }
  float* sg = p.states + int64_t(blockIdx.x) * N * P;
#pragma unroll
  for (int r = 0; r < NROWS; ++r)
#pragma unroll
    for (int c = 0; c < PCOLS; ++c)
      sg[(ty + 16 * r) * P + tx + 16 * c] = st[r][c];
  if (tid == 0) p.chunk_lf[blockIdx.x] = float(cum_last);
}

template <int N, int P>
cudaError_t launch(const Params& p, int n_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<N, P>(p.q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<N, P><<<n_blocks, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t dispatch_p(const Params& p, int n_blocks, int pdim,
                       cudaStream_t stream) {
  switch (pdim) {
    case 16: return launch<N, 16>(p, n_blocks, stream);
    case 32: return launch<N, 32>(p, n_blocks, stream);
    case 64: return launch<N, 64>(p, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All tensors are contiguous
// fp32 in the shapes listed in Params; n_blocks = b * nc * h.  Returns the
// CUDA error code of the launch (0 on success); the kernel runs on
// `stream` and nothing is synchronised.
extern "C" int ssd_chunk_fwd(const float* x, const float* dt,
                             const float* a_log, const float* B,
                             const float* C, float* y, float* states,
                             float* chunk_lf, int n_blocks, int q, int h,
                             int n, int pdim, void* stream) {
  if (q < 1 || q > MAX_Q || h < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.a_log = a_log;
  p.B = B;
  p.C = C;
  p.y = y;
  p.states = states;
  p.chunk_lf = chunk_lf;
  p.q = q;
  p.h = h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return static_cast<int>(dispatch_p<16>(p, n_blocks, pdim, s));
    case 32: return static_cast<int>(dispatch_p<32>(p, n_blocks, pdim, s));
    case 64: return static_cast<int>(dispatch_p<64>(p, n_blocks, pdim, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
