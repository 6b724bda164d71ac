// Flash-attention forward (causal or full, GQA) for Hopper, sm_90a: the
// SIMT variant.
//
// It runs fp32 inputs (tensor cores in bf16 or TF32 do not meet the fp32
// tolerance of 2e-5) and bf16 views whose bases or strides TMA cannot
// describe; every other bf16 call goes to the wgmma kernel in
// flash_fwd_wgmma.cu (the rule: choose_variant in ../kernel.py).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd (body
// _flash_fwd_kernel).  Same function: softmax(q k^T * d^-1/2) v with an
// online softmax, fp32 running max m, running sum l and accumulator acc,
// the finite mask value -1e30 (never -inf, so m_prev - m_new is never NaN),
// the top-left causal mask (keep q_pos >= k_pos), keys >= Skv masked, and
// the output acc / max(l, 1e-30) in the input dtype.
//
// Design.  One CTA of 256 threads per (64-row query tile, batch * q-head).
// The TPU kernel's sequential kv grid axis becomes a loop inside the CTA, so
// m, l and acc stay in registers for the whole row tile.  Per kv tile of 64
// keys: K is staged in shared memory (fp32), S = Q K^T is computed by a
// 16 x 16 thread grid with a 4 x 4 score micro-tile per thread, the row
// max and row sum are reduced across the 16 threads of a row group with
// warp shuffles, P goes to shared memory, V replaces K in the same buffer,
// and acc += P V.  kv tiles strictly above the causal diagonal are never
// visited.  The q-tile order is reversed so the longest causal rows start
// first.  GQA is native: q head h reads kv head h / (Hq / Hkv), K and V
// are never repeated.  Any batch/head/seq strides are taken; the head
// dimension must be contiguous.
//
// Bound.  At the model's shapes (S = 4096, D = 128) the work is
// 4 * D * B * Hq * S(S+1)/2 flops against 2 * (|q| + |k| + |v| + |o|)
// bytes: about 1,500 flops per byte, far above the H100's ~295 bf16
// flops per byte, so the kernel is bound by operations.  This variant
// multiplies in fp32 on the CUDA cores from fp32 shared-memory tiles
// (bf16 inputs are widened on load), at some 26 TFLOP/s; the tensor cores
// are flash_fwd_wgmma.cu's.  Shared memory: Q tile, one
// K/V tile and the P tile, padded by one float per row so column reads
// hit distinct banks: 82,688 bytes at D = 128 (74,496 at D = 112, the
// zamba2-7b head), which needs the dynamic shared-memory opt-in and leaves
// room for two CTAs per SM.  Head dims 32, 64, 112 and 128 are built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;    // query rows per CTA
constexpr int BLOCK_N = 64;    // keys per kv tile
constexpr int NTHREADS = 256;  // 16 x 16 thread grid
constexpr int ROWS = 4;        // score rows per thread
constexpr int COLS = 4;        // score columns per thread (stride 16)
constexpr float MASK_VALUE = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int hq, hkv, sq, skv;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t(BLOCK_M) * (D + 1) + size_t(BLOCK_N) * (D + 1) +
          size_t(BLOCK_M) * (BLOCK_N + 1)) * sizeof(float);
}

// rows [row0, row0 + nrows) of a (seq, D) slice with row stride `ss`
// into an fp32 tile with row stride D + 1; rows past `limit` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t ss, int row0, int nrows,
                                          int limit) {
  for (int i = threadIdx.x; i < nrows * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    const int s = row0 + r;
    dst[r * (D + 1) + c] = s < limit ? to_float(src[s * ss + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = D + 1;
  constexpr int LDP = BLOCK_N + 1;
  constexpr int DCOLS = D / 16;  // accumulator columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;                 // BLOCK_M x LD
  float* KVs = Qs + BLOCK_M * LD;   // BLOCK_N x LD, holds K then V
  float* Ps = KVs + BLOCK_N * LD;   // BLOCK_M x LDP

  const int tx = threadIdx.x % 16;  // column group
  const int ty = threadIdx.x / 16;  // row group: rows ty*4 .. ty*4+3
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int m_block = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int q_start = m_block * BLOCK_M;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<T, D>(Qs, qg, p.q_ss, q_start, BLOCK_M, p.sq);

  float acc[ROWS][DCOLS];
  float m_i[ROWS], l_i[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_i[i] = MASK_VALUE;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[i][j] = 0.f;
  }

  int n_blocks = (p.skv + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    // kv tiles with k_start <= q_start + BLOCK_M - 1; the rest is masked
    const int last = (q_start + BLOCK_M - 1) / BLOCK_N + 1;
    n_blocks = min(n_blocks, last);
  }

  for (int nb = 0; nb < n_blocks; ++nb) {
    const int k_start = nb * BLOCK_N;
    __syncthreads();  // previous tile's reads of KVs / Ps are done
    load_tile<T, D>(KVs, kg, p.k_ss, k_start, BLOCK_N, p.skv);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;

#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qs[(ty * ROWS + i) * LD + c];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = KVs[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int q_pos = q_start + ty * ROWS + i;
      float row_max = MASK_VALUE;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int k_pos = k_start + tx + 16 * j;
        const bool valid = k_pos < p.skv && (!p.causal || q_pos >= k_pos);
        s[i][j] = valid ? s[i][j] * p.scale : MASK_VALUE;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the 16 threads of a row group are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_i[i], row_max);
      const float corr = expf(m_i[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_i[i] = l_i[i] * corr + row_sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        Ps[(ty * ROWS + i) * LDP + tx + 16 * j] = s[i][j];
    }

    __syncthreads();  // every thread is done reading K; P is visible
    load_tile<T, D>(KVs, vg, p.v_ss, k_start, BLOCK_N, p.skv);
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(ty * ROWS + i) * LDP + n];
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) {
        const float vv = KVs[n * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q_start + ty * ROWS + i;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DCOLS; ++j)
      store(og + row * p.o_ss + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.hq, (p.sq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int batch, int d,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 112: return launch<T, 112>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `strides` holds 12 element
// strides: (batch, head, seq) for q, k, v and o in that order.  Returns the
// CUDA error code of the launch (0 on success); the kernel runs on
// `stream` and nothing is synchronised.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int batch,
                                   int hq, int hkv, int sq, int skv, int d,
                                   float scale, int causal, int is_bf16,
                                   void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(p, batch, d, s)
              : dispatch_d<float>(p, batch, d, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
