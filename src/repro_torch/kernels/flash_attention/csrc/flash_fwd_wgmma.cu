// Flash-attention forward, bf16, for Hopper (sm_90a): wgmma on TMA tiles.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd (body
// _flash_fwd_kernel) for bf16 inputs.  Same function as the SIMT kernel in
// flash_fwd.cu, which stays for fp32 and for bf16 views TMA cannot
// describe: softmax(q k^T d^-1/2) v with an online softmax, fp32 running
// max m, sum l and accumulator acc, the finite mask value -1e30, the
// top-left causal mask (keep q_pos >= k_pos), keys >= Skv masked, output
// acc / max(l, 1e-30) rounded to bf16.  GQA is native: q head h reads kv
// head h / (Hq / Hkv); K and V are never repeated.
//
// Bound.  At the model shapes (S = 4096, D = 64-128) attention does some
// 1,000-1,500 flops per byte moved, far above the H100's 295 bf16 flops a
// byte: it is bound by operations, and only wgmma reaches the tensor
// cores' full rate.
//
// Design.  One CTA of three warpgroups per (128-row query tile, batch *
// q-head), the heaviest causal tiles launched first:
//  * warpgroup 2 is the producer.  It gives up registers (setmaxnreg) and
//    one thread issues every TMA load: the Q tile once, then the K and V
//    tiles of BN keys through a ring of 3 stages, each stage a full
//    barrier for K, one for V and an empty barrier the consumers arrive on.
//    The tensor maps are 4-D, (D, S, H, B) with the caller's strides, so a
//    (B, S, H, D) tensor is read through its transposed view, no copy.
//  * warpgroups 0 and 1 each own 64 query rows.  S = Q K^T is one chain of
//    wgmma m64nBNk16 with both operands in shared memory (Q and K are
//    K-major: D is contiguous).  The online softmax runs on the fp32
//    accumulator's fragment layout in registers (a row's max and sum
//    reduced over the 4 lanes that share it), in base 2 with the scale
//    folded into one FFMA before each ex2.approx.  P is rounded to bf16
//    into the wgmma A-fragment layout and O += P V is wgmma RS (A from
//    registers) with V MN-major in shared memory (the transpose bit).
//    Masking arithmetic runs only on tiles that touch the diagonal or the
//    end of the keys; tiles strictly above the diagonal are never loaded.
//  * What bounds this design on the card is not the tensor cores but the
//    softmax between them (tools/kernel_ablation.py times the kernel with
//    the softmax taken out, and with K and V no longer streamed, which
//    costs nothing measurable), so the schedule hides it.  Inside a warpgroup,
//    tile n's S = Q K^T and tile n-1's O += P V are issued together and
//    the softmax of S_n runs while P V is on the tensor cores; O is
//    rescaled once P V has retired.  Between the warpgroups, named
//    barriers pass a turn (ping-pong): one issues its products, hands the
//    turn over, and runs its softmax while the other's products hold the
//    tensor cores.  A stage is released when its P V has retired.
//  * ptxas compiles the consumers within the 168 registers a thread has at
//    launch (65,536 over 384 threads; setmaxnreg only moves registers at
//    run time) and serialises every wgmma when S, P and O do not fit, so
//    the key tile is BN = 96 at DP = 128 and 128 at DP = 64 (Layout).
//  * Head dims are padded to DP = 64 (D 32, 64) or 128 (D 112, 128): the
//    tensor map's inner extent is D, so TMA zero-fills columns D..DP-1 of
//    64-column, 128-byte-swizzled boxes, the products run at K = DP and the
//    padded output columns are never stored.
//  * The epilogue divides by l and stores bf16 pairs straight from the
//    accumulator, masking rows >= Sq (ragged query tiles).
//
// Rounding P to bf16 before P V is the one rounding this adds to the
// function (the TPU's MXU takes bf16 passes for an f32 dot at JAX's
// default precision too); the bf16 tolerance of tests/test_kernels.py
// covers it.
//
// Shared memory (1024-byte aligned tiles, plus 1 KB to align the base):
// Q 128 x DP + 3 x (K + V) BN x DP bf16: 181,328 bytes at DP = 128,
// 115,792 at DP = 64 (wgmma_smem_bytes in ../kernel.py mirrors this).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_M = 128;   // query rows per CTA: two consumer warpgroups
constexpr int STAGES = 3;      // K/V ring depth
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Keys per K/V tile.  A consumer thread holds S (BN / 2 floats), P (BN / 4
// registers) and O (DP / 2 floats) at once; ptxas compiles it within 168
// registers (65,536 over 384 threads) and serialises every wgmma when they
// do not fit, so DP = 128 takes 96 keys (48 + 24 + 64) and DP = 64 takes
// 128 (64 + 32 + 32).
template <int DP>
struct Layout {
  static constexpr int BN = DP == 64 ? 128 : 96;
  static constexpr int BOXES = DP / 64;             // 64-column boxes
  static constexpr int Q_BYTES = BLOCK_M * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;      // one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;     // q, k full, v full, empty
  static constexpr int ALLOC = BAR_OFF + N_BARS * 8 + 1024;
  static_assert(KV_BYTES % 1024 == 0, "swizzle atoms stay 1024-aligned");
};

struct Params {
  void* o;
  long long o_sb, o_sh, o_ss;
  int hq, hkv, sq, skv, d;
  float scale_log2;   // d^-1/2 * log2(e)
  int causal;
};

// The query rows a thread holds: accumulator registers 4 i + {0, 1} are
// row lo, 4 i + {2, 3} row hi; wg_row0 is its warpgroup's first row.
struct Rows {
  int lo, hi, wg_row0;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of the two rows a thread holds, in base 2: running
// max m (of the scaled scores), this thread's share of the running sum l
// (the 4 lanes of a row are summed once, at the end) and the last step's
// correction exp2(m_old - m_new) for the accumulator.  The softmax is the
// kernel's limit, so each score costs one FFMA (scale and max folded) and
// one ex2.approx, tiles clear of the diagonal and of the end of the keys
// skip the masking arithmetic, and O is rescaled only when a max moved.
template <int BN>
struct Softmax {
  float m_lo = MASK_VALUE, m_hi = MASK_VALUE;
  float l_lo = 0.f, l_hi = 0.f;
  float corr_lo = 1.f, corr_hi = 1.f;

  // S (unscaled Q K^T of keys k_start ..) -> P = exp2(S scale - m) in place
  template <bool MASKED>
  __device__ __forceinline__ void step(float (&sc)[BN / 2], int k_start,
                                       const Rows& r, const Params& p,
                                       int lane) {
    float mx_lo = MASK_VALUE, mx_hi = MASK_VALUE;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      if (MASKED) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k_start + 8 * i + 2 * (lane % 4) + (j % 2);
          const int row = j < 2 ? r.lo : r.hi;
          if (col >= p.skv || (p.causal && col > row))
            sc[4 * i + j] = MASK_VALUE;
        }
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    // the scale is positive, so the max of scaled scores is the scaled max
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) * p.scale_log2);
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) * p.scale_log2);
    corr_lo = mn_lo == m_lo ? 1.f : exp2_approx(m_lo - mn_lo);
    corr_hi = mn_hi == m_hi ? 1.f : exp2_approx(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      sc[4 * i] = exp2_approx(fmaf(sc[4 * i], p.scale_log2, -mn_lo));
      sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], p.scale_log2, -mn_lo));
      sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], p.scale_log2, -mn_hi));
      sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], p.scale_log2, -mn_hi));
      sum_lo += sc[4 * i] + sc[4 * i + 1];
      sum_hi += sc[4 * i + 2] + sc[4 * i + 3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
  }

  // masking only where a tile reaches past the diagonal or the keys' end
  __device__ __forceinline__ void step(float (&sc)[BN / 2], int k_start,
                                       const Rows& r, const Params& p,
                                       int lane) {
    if (k_start + BN > p.skv || (p.causal && k_start + BN - 1 > r.wg_row0))
      step<true>(sc, k_start, r, p, lane);
    else
      step<false>(sc, k_start, r, p, lane);
  }

  // O *= corr; skipped (exactly: a product by 1) when no row of the warp
  // has a new max, as on most tiles after the first few
  template <int N>
  __device__ __forceinline__ void rescale(float (&o)[N]) const {
    if (__all_sync(0xffffffffu, corr_lo == 1.f && corr_hi == 1.f)) return;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      o[4 * i] *= corr_lo;
      o[4 * i + 1] *= corr_lo;
      o[4 * i + 2] *= corr_hi;
      o[4 * i + 3] *= corr_hi;
    }
  }
};

// P as bf16 A fragments: keys 16 j .. 16 j + 15 are accumulator registers
// 8 j .. 8 j + 7, already in the m16n8k16 A order.
template <int BN>
__device__ __forceinline__ void to_a_fragments(const float (&sc)[BN / 2],
                                               uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
}

// S = Q K^T for one K tile, committed as one wgmma group (not waited on).
template <int DP, int BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t q_wg,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t box = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = desc_k_major(q_wg + box * BLOCK_M * 128 + off);
    const uint64_t db = desc_k_major(k_tile + box * BN * 128 + off);
    Wgmma<BN, 0>::ss(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for one V tile, committed as one wgmma group (not waited on).
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const uint64_t db = desc_mn_major(v_tile + j * 16 * 128, BN * 128);
    Wgmma<DP, 1>::rs(o, pa[j], db, 1);
  }
  wgmma_commit();
}

// Warpgroup ping-pong: a warpgroup issues its products only in its turn
// and then hands the turn over, so one warpgroup's softmax runs while the
// other's products hold the tensor cores (tools/kernel_ablation.py times
// the kernel without it).  Named barriers 1 and 2 (0 is __syncthreads), 256 threads
// each: the waiting warpgroup and the one that hands over.  Each
// warpgroup takes n_blocks + 1 turns; warpgroup 1 hands warpgroup 0 the
// first turn and does not hand over its last.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  using L = Layout<DP>;
  constexpr int BN = L::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q_OFF;
  const uint32_t k_s = base + L::K_OFF;
  const uint32_t v_s = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int m_block = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int q_start = m_block * BLOCK_M;
  int n_blocks = (p.skv + BN - 1) / BN;
  if (p.causal) n_blocks = min(n_blocks, (q_start + BLOCK_M - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 8);   // lane 0 of each of the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(bar_q, L::Q_BYTES);
      for (int x = 0; x < L::BOXES; ++x)
        tma_load_4d(q_s + x * BLOCK_M * 128, &tq, bar_q, x * 64, q_start, h,
                    b);
      for (int n = 0; n < n_blocks; ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) mbar_wait(bar_e(s), ((n / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(bar_k(s), L::KV_BYTES);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_4d(k_s + s * L::KV_BYTES + x * BN * 128, &tk, bar_k(s),
                      x * 64, n * BN, hk, b);
        mbar_arrive_expect_tx(bar_v(s), L::KV_BYTES);
        for (int x = 0; x < L::BOXES; ++x)
          tma_load_4d(v_s + s * L::KV_BYTES + x * BN * 128, &tv, bar_v(s),
                      x * 64, n * BN, hk, b);
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    Rows r;
    r.lo = q_start + wg * 64 + warp * 16 + lane / 4;
    r.hi = r.lo + 8;
    r.wg_row0 = q_start + wg * 64;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float sc[BN / 2];              // S of the newest tile, then its P
    uint32_t pa[BN / 16][4];       // P of the tile whose P V is next
    Softmax<BN> sm;

    const uint32_t q_wg = q_s + wg * 64 * 128;
    if (wg == 1) turn_pass(wg);    // warpgroup 0 issues first
    mbar_wait(bar_q, 0);

    // tile 0: S, softmax, P
    turn_wait(wg);
    mbar_wait(bar_k(0), 0);
    issue_qk<DP, BN>(sc, q_wg, k_s);
    turn_pass(wg);
    wgmma_wait<0>();
    fence_array(sc);
    sm.step(sc, 0, r, p, lane);
    to_a_fragments<BN>(sc, pa);

    // tile n: S_n = Q K_n^T and O += P_{n-1} V_{n-1} in flight together;
    // the softmax of S_n runs while P V is still on the tensor cores
    for (int n = 1; n < n_blocks; ++n) {
      const int s = n % STAGES, sp = (n - 1) % STAGES;
      turn_wait(wg);
      mbar_wait(bar_k(s), (n / STAGES) & 1);
      issue_qk<DP, BN>(sc, q_wg, k_s + s * L::KV_BYTES);
      mbar_wait(bar_v(sp), ((n - 1) / STAGES) & 1);
      issue_pv<DP, BN>(o, pa, v_s + sp * L::KV_BYTES);
      turn_pass(wg);
      wgmma_wait<1>();             // S_n is done, P V may still run
      fence_array(sc);
      sm.step(sc, n * BN, r, p, lane);
      wgmma_wait<0>();
      fence_array(o);
      if (lane == 0) mbar_arrive(bar_e(sp));
      sm.rescale(o);
      to_a_fragments<BN>(sc, pa);
    }
    const int sl = (n_blocks - 1) % STAGES;
    turn_wait(wg);
    mbar_wait(bar_v(sl), ((n_blocks - 1) / STAGES) & 1);
    issue_pv<DP, BN>(o, pa, v_s + sl * L::KV_BYTES);
    if (wg == 0) turn_pass(wg);    // warpgroup 1's last turn is not awaited
    wgmma_wait<0>();
    fence_array(o);

    // epilogue: the row sums over the 4 lanes of a row, then o / l
    const float inv_lo = 1.f / fmaxf(quad_sum(sm.l_lo), 1e-30f);
    const float inv_hi = 1.f / fmaxf(quad_sum(sm.l_hi), 1e-30f);
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        h * p.o_sh;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      if (col >= p.d) continue;
      if (r.lo < p.sq)
        *reinterpret_cast<uint32_t*>(og + r.lo * p.o_ss + col) =
            pack_bf16(o[4 * i] * inv_lo, o[4 * i + 1] * inv_lo);
      if (r.hi < p.sq)
        *reinterpret_cast<uint32_t*>(og + r.hi * p.o_ss + col) =
            pack_bf16(o[4 * i + 2] * inv_hi, o[4 * i + 3] * inv_hi);
    }
  }
}

// (D, S, H, B) with the caller's element strides (seq, head, batch), boxes
// of 64 columns x `rows` rows of one head.
bool make_map(CUtensorMap* map, const void* ptr, int d, int s, int h, int b,
              const long long* strides, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d),
                            static_cast<uint64_t>(s),
                            static_cast<uint64_t>(h),
                            static_cast<uint64_t>(b)};
  const uint64_t st[3] = {static_cast<uint64_t>(strides[2]) * 2,
                          static_cast<uint64_t>(strides[1]) * 2,
                          static_cast<uint64_t>(strides[0]) * 2};
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return encode_bf16_sw128(map, ptr, 4, dims, st, box);
}

template <int DP>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int batch,
                   cudaStream_t stream) {
  constexpr int smem = Layout<DP>::ALLOC;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.hq, (p.sq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_wgmma_kernel<DP><<<grid, THREADS, smem, stream>>>(tq, tk, tv,
                                                               p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  bf16 only.  `strides` holds 12
// element strides: (batch, head, seq) for q, k, v and o in that order; q,
// k and v need 16-byte aligned bases and strides (TMA), o 4-byte aligned
// rows.  Returns the CUDA error code of the launch (0 on success); the
// kernel runs on `stream` and nothing is synchronised.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides,
                                         int batch, int hq, int hkv, int sq,
                                         int skv, int d, float scale,
                                         int causal, void* stream) {
  if (d != 32 && d != 64 && d != 112 && d != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = d <= 64 ? 64 : 128;
  CUtensorMap tq, tk, tv;
  const int bn = dp == 64 ? Layout<64>::BN : Layout<128>::BN;
  if (!make_map(&tq, q, d, sq, hq, batch, strides + 0, BLOCK_M) ||
      !make_map(&tk, k, d, skv, hkv, batch, strides + 3, bn) ||
      !make_map(&tv, v, d, skv, hkv, batch, strides + 6, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = o;
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dp == 64 ? launch<64>(tq, tk, tv, p, batch, s)
                                   : launch<128>(tq, tk, tv, p, batch, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
