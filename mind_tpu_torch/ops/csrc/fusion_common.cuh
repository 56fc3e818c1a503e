// Shared pieces of the two fused edge-attention kernels for Hopper (sm_90a):
// the widths, cp.async helpers, and the per-token prologue and epilogue
// kernels. Included by fusion_attention.cu (float32) and
// fusion_attention_bf16.cu (bf16 operands on the tensor cores).
//
// Both variants replace the TPU kernel mind_tpu/ops/fusion_attention.py::_kernel
// and split one call into three launches on the caller's stream:
//
//   1. token_proj_kernel: the products that depend on one token only,
//      computed once per call (not once per block and chunk), one product
//      per block:
//        sp[t] = node[t] Wm_s,  tp[t] = node[t] Wm_t + bm,  q[t] = node[t] Wq + bq
//      and, for the float32 variant, the folded key projection
//        qk[t][h][:] = Wk[:, head h] q_h[t] / sqrt(dh)            ([NH x D] per token)
//   2. the per-(source, target) main kernel of the variant;
//   3. out_proj_kernel: the per-token output product(s), out Wo + bo.
//
// In the bf16 variant the operands of these per-token products are rounded to
// bf16 and multiplied in float32 FMAs: a product of two bf16 values is exact
// in float32, so this is the tensor core's arithmetic up to the order of the
// float32 sum. They are 0.2% of the call's operations.
//
// Widths. Every kernel is a template over a Widths<D, E, NH> type: node width
// D, edge width E, NH heads of dh = D / NH, any NH that divides D, as the TPU
// kernel takes them (fusion_attention.py::kernel_domain refuses only what the
// JAX function refuses). A library is built for one shape: the build defines
// FUSION_D, FUSION_E, FUSION_NH and FUSION_QK_SCALE (float32(1 / sqrt(dh)) of
// the true dh, computed on the host as the JAX kernel computes it), and each
// source instantiates its kernels for `Shape`. Every width is a compile-time
// constant of its library, and so is its layout:
//
// - resident (Widths::RESIDENT: D and E multiples of 16 from 16 to 128, at
//   most 16 heads of a width that is a multiple of 8): the per-pair weights
//   stay in shared memory, as each source's header sets out; the main
//   path's 128 / 128 / 8 is one;
// - tiled (every other shape; fusion_tiled.cuh): every per-pair product is
//   one product over all the call's pairs in tiles of 128 pairs, its
//   weights streamed through a ring of shared-memory stages, and every
//   width and head layout is taken at its true size; the whole-row steps run
//   in the products' epilogues or in row passes over a scratch the caller
//   allocates. Kernel A folds keys and values there from a head width of 8.
//
// No run-time width test or index costs a library anything. The per-token
// kernels below serve the resident layout and kernel B's tiled route (kernel
// A's tiled route has its own, fusion_tiled.cuh): a thread owns columns
// tid, tid + 128, ..., and rows are staged zero-padded to a multiple of 16
// (DP), so a width that is not a multiple of 16, or above 128, costs the
// resident shapes nothing (DP == D and one column a thread there). Past 512
// columns a block takes 512 of them (token_cols), and past 1,280 the staged
// rows are cut into chunks of k (token_chunk), so that their static shared
// memory is bounded whatever the width.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FUSION_D
#define FUSION_D 128
#endif
#ifndef FUSION_E
#define FUSION_E 128
#endif
#ifndef FUSION_NH
#define FUSION_NH 8
#endif
#ifndef FUSION_QK_SCALE
#define FUSION_QK_SCALE 0.25
#endif

namespace fusion {

constexpr int TI = 8;           // sources per chunk
constexpr int NT = 128;         // threads per block: the per-token kernels and kernel A
constexpr int TOK = 8;          // tokens per block in the per-token kernels
constexpr float LN_EPS = 1e-5f;
constexpr float MASKED = -1e9f;

template <int D_, int E_, int NH_>
struct Widths {
  static constexpr int D = D_;          // node width
  static constexpr int E = E_;          // edge width
  static constexpr int NH = NH_;        // heads
  static constexpr int DH = D_ / NH_;   // head width
  static_assert(D >= 1 && E >= 1 && NH >= 1 && D % NH == 0,
                "positive widths, and a head count that divides D");
  // the resident layout's shapes (the others take the tiled one)
  static constexpr bool RESIDENT = D % 16 == 0 && E % 16 == 0 && D >= 16 && E >= 16 &&
                                   D <= 128 && E <= 128 && NH <= 16 && DH % 8 == 0;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Values of k a block of the per-token kernels stages at once: the whole
// padded row (every width to 1,280; TOK rows then take at most 40 KB of
// static shared memory, twice that row with the folded keys), or chunks of
// TOKEN_KC values; the sum over k runs from 0 up either way.
constexpr int TOKEN_KC = 1280;
template <class S, bool FOLD>
__host__ __device__ constexpr int token_chunk() {
  return round_up(S::D, 16) * TOK * 4 * (FOLD ? 2 : 1) <= 40960 ? round_up(S::D, 16)
                                                                 : TOKEN_KC;
}

// Output columns a block of the per-token kernels takes: all D up to 512,
// else 512 (a grid dimension of ceil(D / 512) blocks), so that a wide
// product spreads over the card and a thread's chain of loads stays short.
constexpr int TOKEN_COLS = 512;
template <class S>
__host__ __device__ constexpr int token_cols() {
  return S::D <= TOKEN_COLS ? S::D : TOKEN_COLS;
}
template <class S>
__host__ __device__ constexpr int token_col_blocks() {
  return (S::D + token_cols<S>() - 1) / token_cols<S>();
}

// The shape this library is built for.
struct Shape : Widths<FUSION_D, FUSION_E, FUSION_NH> {
  static constexpr float QK_SCALE = (float)(FUSION_QK_SCALE);   // 1 / sqrt(dh)
};

// The device's opt-in shared memory a block (cached per device), for the
// launchers' check of a layout before they set it.
inline int smem_optin() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cached[dev];
}
// Returned by a launcher, before any launch, when a layout does not fit.
constexpr int ERR_SMEM = -1;

// Biases and LayerNorm parameters, in the type of the variant's weights
// (float32, or bf16 as the bf16 network holds them); read as float32.
// be and the two edge LayerNorms are E wide, the others D.
template <typename WT>
struct VecsT {
  const WT *bm, *ln_m_g, *ln_m_b, *bq, *bk, *bv, *bo, *be;
  const WT *ln_e1_g, *ln_e1_b, *ln_e2_g, *ln_e2_b;
};
using Vecs = VecsT<float>;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// An activation as a product sees it: as it is against float32 weights,
// rounded to bf16 against bf16 weights.
template <typename WT> __device__ __forceinline__ float operand(float x) { return x; }
template <> __device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return round_bf16(x);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid (the
// source address must still be a mapped one).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// acc[r] += sum_k xs[r][k - kb] w[k][col] over the chunk kb <= k < kb + KC
// (k < D), for ROWS rows out of shared memory (rows of KC values, zero past
// D) and one weight column per thread out of global memory (w is [D][D]).
// The weight column is fetched 16 values at a time, so 16 loads are in flight
// before the first FMA needs one: these kernels are short chains of L2
// latencies otherwise. Every block sums over k from 0 up: the order of a
// token's sum must not depend on the block it lands in, or a token would
// compute another value in a batch of scenes than alone.
// ---------------------------------------------------------------------------
template <int D, int KC, int ROWS, typename WT>
__device__ __forceinline__ void token_mm(const float (*xs)[KC], const WT* __restrict__ w,
                                         int col, int kb, float acc[ROWS]) {
  constexpr int DP = round_up(D, 16);
#pragma unroll 1
  for (int k0 = 0; k0 < KC && (KC == DP || kb + k0 < DP); k0 += 16) {
    float wr[16];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int k = kb + k0 + kk;
      wr[kk] = DP == D || k < D ? to_f(w[(size_t)k * D + col]) : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 16; kk += 4) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(&xs[r][k0 + kk]);
        acc[r] = fmaf(x.x, wr[kk], acc[r]);
        acc[r] = fmaf(x.y, wr[kk + 1], acc[r]);
        acc[r] = fmaf(x.z, wr[kk + 2], acc[r]);
        acc[r] = fmaf(x.w, wr[kk + 3], acc[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Prologue: per-token projections. Grid (ceil(tokens / TOK), 3,
// token_col_blocks): a block of 128 threads takes TOK tokens, one product
// (blockIdx.y = 0: sp, 1: tp, 2: q and, with FOLD, the folded keys) and
// token_cols output columns (blockIdx.z); thread t owns columns t, t + 128,
// ... of them below D.
// ---------------------------------------------------------------------------
template <class S, typename NodeT, typename WT, bool FOLD>
__global__ void __launch_bounds__(NT)
token_proj_kernel(const NodeT* __restrict__ node, const WT* __restrict__ wm_s,
                  const WT* __restrict__ wm_t, const WT* __restrict__ wq,
                  const WT* __restrict__ wk, VecsT<WT> v, float* __restrict__ sp,
                  float* __restrict__ tp, float* __restrict__ q_out, int tokens) {
  constexpr int D = S::D, NH = S::NH, DH = S::DH, DP = round_up(D, 16);
  constexpr int TR = TOK, KC = token_chunk<S, FOLD>(), CB = token_cols<S>();
  static_assert(!FOLD || (S::RESIDENT && DP == D), "the folded keys are the resident layout's");
  __shared__ __align__(16) float xs[TR][KC];
  __shared__ __align__(16) float qs[FOLD ? TR : 1][FOLD ? DP : 1];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TR;
  const int which = blockIdx.y;
  const int cb0 = blockIdx.z * CB;
  // the rows' values kb <= k < kb + KC, zero past D
  auto stage = [&](int kb) {
    for (int idx = tid; idx < TR * KC; idx += NT) {
      const int tok = t0 + idx / KC, k = kb + idx % KC;
      xs[idx / KC][idx % KC] = tok < tokens && (KC == D || k < D)
                                   ? operand<WT>(to_f(node[(size_t)tok * D + k])) : 0.f;
    }
  };
  if constexpr (KC == DP) {
    stage(0);
    __syncthreads();
  }

  const bool col_ok = D == NT || tid < D;   // the folded keys' column (D <= 128)
  const WT* w = which == 0 ? wm_s : which == 1 ? wm_t : wq;
  for (int col0 = cb0; col0 < cb0 + CB; col0 += NT) {
    const int col = col0 + tid;
    const bool on = (D % CB == 0 && CB % NT == 0) || col < D;
    float acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = 0.f;
    if constexpr (KC == DP) {
      if (on) token_mm<D, KC, TR, WT>(xs, w, col, 0, acc);
    } else {
      for (int kb = 0; kb < DP; kb += KC) {
        __syncthreads();   // the chunk before is read
        stage(kb);
        __syncthreads();
        if (on) token_mm<D, KC, TR, WT>(xs, w, col, kb, acc);
      }
    }
    if (on) {
      const float bias = which == 0 ? 0.f : to_f((which == 1 ? v.bm : v.bq)[col]);
      float* dst = which == 0 ? sp : which == 1 ? tp : q_out;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int tok = t0 + r;
        const float val = acc[r] + bias;
        if (tok < tokens && !(FOLD && which == 2)) dst[(size_t)tok * D + col] = val;
        if constexpr (FOLD) qs[r][col] = val;
      }
    }
  }
  if constexpr (FOLD) {
  if (which == 2) {
    // qk[tok][h][c] = sum_d Wk[c][h*dh+d] q[tok][h*dh+d] / sqrt(dh): the
    // logit of (i, j) for head h is then mem[i,j] . qk[j][h]. The bias term
    // bk_h . q_h[j] is the same for every source i and cancels in the
    // softmax, so it is not computed.
    static_assert(sizeof(WT) == 4, "the folded keys are a float32 product");
    __syncthreads();
    const int c = tid;
    if (col_ok) {
#pragma unroll 2
      for (int hs = 0; hs < NH; ++hs) {
        // staggered over the blocks: each head's sum is its own, so the
        // order of the heads changes no value
        const int h = (unsigned)(hs + blockIdx.x) % (unsigned)NH;
        // row c of Wk, head h: dh contiguous float32 values, as 16-byte loads
        float wr[DH];
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 w4 =
              __ldg(reinterpret_cast<const float4*>(wk + (size_t)c * D + h * DH) + d4);
          wr[4 * d4] = w4.x; wr[4 * d4 + 1] = w4.y; wr[4 * d4 + 2] = w4.z; wr[4 * d4 + 3] = w4.w;
        }
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          float a = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) a = fmaf(wr[d], qs[r][h * DH + d], a);
          const int tok = t0 + r;
          if (tok < tokens) q_out[((size_t)tok * NH + h) * D + c] = a * S::QK_SCALE;
        }
      }
    }
  }
  }
}

// Tokens a block of out_proj_kernel: TOK, or TOK / 2 where the folded
// form's [TOK * NH][D] staging would pass the 48 KB of static shared memory;
// without the fold, TOK.
template <class S, bool FOLD>
__host__ __device__ constexpr int out_tokens() {
  return FOLD ? ((TOK * S::NH + TOK) * S::D * 4 > 48 * 1024 ? TOK / 2 : TOK) : TOK;
}

// ---------------------------------------------------------------------------
// Epilogue: out = x Wo + bo per token, where
//   FOLD:  x[t] = ctx[tok][head of t] . Wv[:, t] + bv[t]   (ctx = softmax-weighted
//          sum of mem rows per head, [NH x D] per token; the weights sum to
//          1, so bv is added once)
//   else:  x[t] = attn[tok][t] + bv[t]                      (attn = softmax-weighted
//          sum of the bias-free v rows)
// Grid (ceil(tokens / TK), 1, token_col_blocks): a block takes
// out_tokens<S, FOLD>() tokens and token_cols output columns.
// ---------------------------------------------------------------------------
template <class S, typename WT, bool FOLD>
__global__ void __launch_bounds__(NT)
out_proj_kernel(const float* __restrict__ in, const WT* __restrict__ wv,
                const WT* __restrict__ wo, VecsT<WT> v, float* __restrict__ out,
                int tokens) {
  constexpr int D = S::D, NH = S::NH, DH = S::DH, DP = round_up(D, 16);
  constexpr int TK = out_tokens<S, FOLD>(), KC = token_chunk<S, false>();
  constexpr int CB = token_cols<S>();
  static_assert(!FOLD || (S::RESIDENT && DP == D), "the folded values are the resident layout's");
  __shared__ __align__(16) float cs[FOLD ? TK * NH : 1][FOLD ? D : 1];
  __shared__ __align__(16) float xs[TK][KC];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TK;
  const int cb0 = blockIdx.z * CB;
  float acc[TK];
  // x = attn + bv for kb <= col < kb + KC, zero past D
  auto stage = [&](int kb) {
    for (int c0 = 0; c0 < KC; c0 += NT) {
      const int c = c0 + tid, col = kb + c;
      if (KC % NT == 0 || c < KC) {
        const bool in_row = KC == D || col < D;
        const float bv = in_row ? to_f(v.bv[col]) : 0.f;
#pragma unroll
        for (int r = 0; r < TK; ++r) {
          const int tok = t0 + r;
          xs[r][c] = tok < tokens && in_row ? operand<WT>(in[(size_t)tok * D + col] + bv) : 0.f;
        }
      }
    }
  };
  if constexpr (FOLD) {
    const int col = tid;
    const bool col_ok = D == NT || col < D;
    const float bv = col_ok ? to_f(v.bv[col]) : 0.f;
    for (int idx = tid; idx < TK * NH * D; idx += NT) {
      const int tok = t0 + idx / (NH * D);
      cs[idx / D][idx % D] = tok < tokens ? in[(size_t)t0 * NH * D + idx] : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      // row r of this product is token r's accumulator of the thread's head
      const int h = col / DH;
#pragma unroll
      for (int r = 0; r < TK; ++r) acc[r] = 0.f;
#pragma unroll 1
      for (int k0 = 0; k0 < D; k0 += 16) {   // from 0 up, as in token_mm
        float wr[16];
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) wr[kk] = to_f(wv[(size_t)(k0 + kk) * D + col]);
#pragma unroll
        for (int kk = 0; kk < 16; kk += 4) {
#pragma unroll
          for (int r = 0; r < TK; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(&cs[r * NH + h][k0 + kk]);
            acc[r] = fmaf(x.x, wr[kk], acc[r]);
            acc[r] = fmaf(x.y, wr[kk + 1], acc[r]);
            acc[r] = fmaf(x.z, wr[kk + 2], acc[r]);
            acc[r] = fmaf(x.w, wr[kk + 3], acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TK; ++r) xs[r][col] = operand<WT>(acc[r] + bv);
    }
    __syncthreads();
  } else if constexpr (KC == DP) {
    stage(0);
    __syncthreads();
  }
  for (int col0 = cb0; col0 < cb0 + CB; col0 += NT) {
    const int col = col0 + tid;
    const bool on = (D % CB == 0 && CB % NT == 0) || col < D;
#pragma unroll
    for (int r = 0; r < TK; ++r) acc[r] = 0.f;
    if constexpr (FOLD || KC == DP) {
      if (on) token_mm<D, KC, TK, WT>(xs, wo, col, 0, acc);
    } else {
      for (int kb = 0; kb < DP; kb += KC) {
        __syncthreads();   // the chunk before is read
        stage(kb);
        __syncthreads();
        if (on) token_mm<D, KC, TK, WT>(xs, wo, col, kb, acc);
      }
    }
    if (on) {
      const float bo = to_f(v.bo[col]);
#pragma unroll
      for (int r = 0; r < TK; ++r) {
        const int tok = t0 + r;
        if (tok < tokens) out[(size_t)tok * D + col] = acc[r] + bo;
      }
    }
  }
}

}  // namespace fusion
