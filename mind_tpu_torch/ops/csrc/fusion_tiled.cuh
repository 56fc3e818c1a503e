// The tiled route of the fused edge-attention kernels (sm_90a): both
// variants at every shape outside the resident layout (fusion_common.cuh's
// Widths::RESIDENT): widths above 128, widths that are not multiples of 16,
// and any head layout (a head width of 1 to D). Included by
// fusion_attention.cu (float32: plain FMA, no TF32) and
// fusion_attention_bf16.cu (bf16 operands on the tensor cores, float32 sums).
//
// Replaces, as the resident kernels do, the TPU kernel
// mind_tpu/ops/fusion_attention.py::_kernel, here at the rest of its domain.
//
// What bounds it. Past 128 wide the call is a few large products: per
// (scene, source, target) pair an [E x D] memory product, a [D x E] edge
// update and, unfolded, two [D x D] key and value products. Their weights
// are too large to stay in a block's shared memory, so whatever serves a
// weight tile to only a few pairs streams every weight again from L2 for
// every few pairs (the column-block design this replaces: 8-64 pairs a
// weight tile, 0.2-17% of its bound, slower than plain from 512 wide).
//
// The design: pair tiles. Every per-pair product is one product over all
// P = B N N pairs of the call, the pairs its rows, the weight as it lies in
// memory its right operand:
//
//   S[P, N] = X[P, K] W[K, N]     (X: the edge, or the memory rows mem[P, D])
//
// - a block takes a tile of BM = 128 pairs by 128 output columns (64 where
//   a product is at most 64 wide), so each weight tile that reaches
//   shared memory serves 128 pairs; the grid is the output tiles, in groups
//   of GROUP_M row tiles with the row tile fastest, so that the blocks in
//   flight share their weight columns and their rows in L2, and every shape
//   fills the card (8192 / 256 / 64 at B = 1, N = 33: 9 x 64 tiles);
// - K runs through a ring of shared-memory stages filled asynchronously:
//   bf16 (product_bf16): a producer warpgroup and two consumer warpgroups
//   of wgmma.mma_async.m64nNk16 (bf16 from shared memory, float32 sums in
//   registers), 4 stages of 64 k, signalled by mbarriers (full: the
//   producer's copies landed; empty: both consumers are done with the
//   stage). The rows arrive by TMA (128B swizzle, K-major); a weight by TMA
//   where its row is a whole number of 16 bytes (128B swizzle, MN-major:
//   wgmma reads it transposed, so no weight is re-laid out on the host),
//   else by the producer's element copies into the same swizzled layout
//   (a 515- or 7-wide bf16 row is only 2-byte aligned, below cp.async's
//   4); the edge is cast to a zero-padded bf16 copy first where it is
//   float32 or its row is not a whole number of 16 bytes (cast_pass);
//   float32 (product_f32): a register-tiled FMA product, 8 x 8 a thread,
//   128 x 128 a block of 256 (8 x 4, 128 x 64 where the product is at most
//   64 wide), fed by cp.async (16 bytes where the rows allow, 4 otherwise)
//   through 4 stages of 16 k, one cp.async group and one block barrier a
//   stage;
// - out-of-range k and n are zero-filled in shared memory only (TMA's
//   out-of-bounds fill, cp.async's source size);
// - the whole-row steps (the LayerNorms over D or E, relu, the residual,
//   the softmax over sources, the attention sum) run in the product's
//   epilogue where a tile holds the whole row (D or E <= EPI_MAX = 128:
//   the memory LayerNorm, or the edge update's two, straight out of the
//   accumulators), and otherwise in row passes over a float32 scratch the
//   wrapper allocates (mem_pass, edge_pass); logits, softmax and the
//   attention sum are passes over the call's pairs;
// - kernel A folds keys and values where the head width is at least 8
//   (Layout::FOLD), as the resident A does: the logits are mem . qt_h with
//   qt_h = Wk[:, h] q_h / sqrt(dh) (FoldKeys, a product over the tokens per
//   head), the output (sum_i p mem) Wv[:, h] (FoldValues); per pair there
//   remain the memory product, the edge update and two [NH x D] products
//   (LogitsFold, ContextFold: per-token products over the token's
//   sources). Below a head width of 8 the fold saves less than a
//   factor of 8 and qt takes B N D^2 / dh floats (B N D^2 at a head width
//   of 1), so A computes k and v by two [D x D] products, as B always does:
//   B's bf16 rounding of mem before Wk and Wv is part of what the JAX bf16
//   mode computes;
// - kernel A's per-token products (sp, tp, q, the output product, the
//   folded keys and values) are token_product tiles over the call's tokens,
//   so a weight is read once for every 64 tokens, where the resident
//   layout's per-token kernels (fusion_common.cuh) read it once for every
//   8; kernel B keeps those kernels' float32 FMAs for sp, tp, q and the
//   output product: summed on the tensor cores, they moved B's mean error
//   against its plain version at 512 / 512 / 16 from 8.7e-5 to 1.3e-4,
//   past its 1e-4 tolerance (PERF.md);
// - bk is never added: its logit term bk_h . q_h[j] is the same for every
//   source and cancels in the softmax; bv is added once per target by the
//   output product (the softmax weights sum to 1).
//
// Scratch (bytes a pair, Layout::PAIR_S/M/L; the wrapper allocates
// pair_scratch_bytes(P, B N)): S, float32 products [P, LDS] (absent where
// every LayerNorm runs in an epilogue and A folds); M, the memory rows in the
// operand type [P, LDM] (bf16: first the cast edge); L, the logits [P, NH]
// (in the key product's epilogue where no head straddles two tiles), and the
// softmax statistics [B N, NH] from which the consumers take the weights.
//
// Determinism: tile shapes, the K order and every reduction order are
// functions of (D, E, heads) alone, never of B or N: a pair's sums run over
// k from 0 up whatever tile it lands in, there is no split-K and no float
// atomic, so a scene computes in a batch what it computes alone, to the bit.
//
// Bound: as the resident kernels, by operations in float32 (counted folded,
// fusion_attention.py::fused_edge_attention_flops) and in bf16 from 512
// wide, by bytes in bf16 below; PERF.md gives the times.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <string.h>

#include <type_traits>

#include "fusion_common.cuh"

namespace fusion {
namespace tiled {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // pairs a product tile
constexpr int GROUP_M = 8;       // row tiles of a launch-order group
constexpr int EPI_MAX = 128;     // widest row a tile holds whole (its LayerNorm in the epilogue)
constexpr int LN_REG_MAX = 64;   // values a lane of a row pass's register LayerNorm
constexpr int P_NT = 256;        // threads a block of the passes
// float32 product: 128 x BN a block of 256 threads, 8 x BN / 16 a thread
constexpr int F_NT = 256, F_BK = 16, F_STAGES = 4;
constexpr int F_LDA = F_BK + 4;                          // a stage's row of X (floats)
template <int BN> __host__ __device__ constexpr int f_stage() { return BM * F_LDA + F_BK * BN; }
// dynamic shared memory of a float32 product: 73,728 B at 128 columns
template <int BN> __host__ __device__ constexpr int f_smem() {
  return F_STAGES * f_stage<BN>() * 4;
}
// bf16 product: a producer warpgroup and two consumer warpgroups of 64 rows
constexpr int H_NT = 384, H_BK = 64, H_STAGES = 4;
constexpr int H_A_BYTES = BM * H_BK * 2;                 // 16 KB: 128 rows of 128 B
constexpr int H_W_BOX = H_BK * 64 * 2;                   // 8 KB: 64 k rows of 64 columns
// W's descriptor: 64-column groups 8 KB apart (LBO), 8-k groups 1 KB apart (SBO)
constexpr int W_LBO = H_W_BOX, W_SBO = 1024;
template <int BN> __host__ __device__ constexpr int h_stage() { return H_A_BYTES + H_BK * BN * 2; }
// dynamic shared memory of a bf16 product: the stages and 1 KB to align them
template <int BN> __host__ __device__ constexpr int h_smem() {
  return H_STAGES * h_stage<BN>() + 1024;
}
// a fold pass's tile: 64 x 64 outputs of one token, 16 k a step
constexpr int Q_T = 64, Q_K = 32;   // rows of a tile, k a step
constexpr int ERR_TMA = -2;      // a tensor map could not be encoded (before any launch)

enum { EPI_STORE = 0, EPI_MEM = 1, EPI_EDGE = 2, EPI_LOGITS = 3 };

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The library's route at its widths and weight type WT.
template <class S, typename WT>
struct Layout {
  static constexpr int D = S::D, E = S::E, NH = S::NH, DH = S::DH;
  static constexpr bool BF = sizeof(WT) == 2;
  static constexpr bool FOLD = !BF && DH >= 8;            // kernel A from a head width of 8
  static constexpr bool EPI_MEM_LN = D <= EPI_MAX;        // memory LayerNorm in the epilogue
  static constexpr bool EPI_EDGE_LN = E <= EPI_MAX;       // edge LayerNorms in the epilogue
  static constexpr int BN_D = D <= 64 ? 64 : 128;         // tile columns of a D-wide product
  static constexpr int BN_E = E <= 64 ? 64 : 128;         // of the E-wide edge update
  static constexpr int BN = cmax(BN_D, BN_E);
  // the unfolded logits in the key product's epilogue where no head
  // straddles two tiles (bf16: the head width divides the tile's columns;
  // float32: it divides a thread's 4 adjacent columns)
  static constexpr bool EPI_LOGITS_OK = BF ? BN_D % DH == 0 : !FOLD && 4 % DH == 0;
  static constexpr int STAGES = BF ? H_STAGES : F_STAGES;
  static constexpr int LDS = round_up(cmax(D, E), 4);     // S row (floats)
  // M row (elements): bf16 rows are whole 16-byte pieces for TMA, and hold
  // the cast edge first, whose rows must be the memory rows' (they alias)
  static constexpr int LDM = BF ? round_up(cmax(D, E), 8) : round_up(D, 4);
  static constexpr bool NEED_S = !EPI_MEM_LN || !EPI_EDGE_LN || !FOLD;
  static constexpr int PAIR_S = NEED_S ? LDS * 4 : 0;
  static constexpr int PAIR_M = LDM * (int)sizeof(WT);
  static constexpr int PAIR_L = NH * 4;
  // the largest dynamic shared memory of the library's products
  static constexpr int SMEM_BYTES = BF ? h_smem<BN>() : f_smem<BN>();
  static_assert(SMEM_BYTES <= 232448, "a product's stages must fit the H100's shared memory");
};

inline size_t ru256(size_t x) { return (x + 255) / 256 * 256; }

// Bytes of the pair scratch of a call over `pairs` pairs of `tokens` tokens
// (S, M, L and the softmax statistics [tokens, NH] of 8 bytes, each 256-byte
// aligned).
template <class L>
inline size_t pair_scratch_bytes(size_t pairs, size_t tokens) {
  return ru256(pairs * L::PAIR_S) + ru256(pairs * L::PAIR_M) + ru256(pairs * L::PAIR_L) +
         ru256(tokens * L::NH * 8);
}

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Tile `id` of a launch -> (row tile, column tile): groups of GROUP_M row
// tiles, the row tile fastest within a group.
__device__ __forceinline__ void tile_of(int id, int mtiles, int ntiles, int& mt, int& nt) {
  const int per_group = GROUP_M * ntiles;
  const int g = id / per_group, first = g * GROUP_M;
  const int gm = min(GROUP_M, mtiles - first);
  const int r = id - g * per_group;
  mt = first + r % gm;
  nt = r / gm;
}

// Pair p = (scene, source, target) of a call over n nodes -> its source's
// and its target's token (scene * n + node); a call has fewer than 2^31
// pairs (run_pairs refuses more), so 32-bit division serves.
__device__ __forceinline__ long long tok_source(long long p, int n) {
  return (unsigned)p / (unsigned)n;
}
__device__ __forceinline__ long long tok_target(long long p, int n) {
  const unsigned q = (unsigned)p / (unsigned)n;
  return (long long)(q / (unsigned)n) * n + ((unsigned)p - q * (unsigned)n);
}

// cp.async of `bytes` (0 to 16) into 16 bytes of shared memory, zero-filling
// the rest; and of one 4-byte value (or zero).
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V adjacent floats out of shared memory in one load (V = 1, 2 or 4; the
// address a multiple of V floats).
template <int V>
__device__ __forceinline__ void load_row(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x, o[1] = a.y;
  } else {
    o[0] = *p;
  }
}

template <typename T> __device__ __forceinline__ T to_op(float x);
template <> __device__ __forceinline__ float to_op<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 to_op<bf16>(float x) { return __float2bfloat16_rn(x); }

// mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete. A wait that outlasts
// any stage by far (a lost arrival) ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_u32(b);
  for (long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1L << 24)) __trap();
  }
}
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// TMA: a 2-D box at (x inner, y outer) of the map into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// A wgmma descriptor of a 128B-swizzled tile (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// acc (+)= a[64 x 16] b[16 x N]: a K-major, b MN-major (read transposed).
template <int N>
__device__ __forceinline__ void wgmma_tn(float (*acc)[4], uint64_t da, uint64_t db, int accumulate);
#define TILED_ACC4(i) "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
#define TILED_WGMMA(N, REGS, DA, DB, P, ...)                                               \
  template <>                                                                              \
  __device__ __forceinline__ void wgmma_tn<N>(float (*acc)[4], uint64_t da, uint64_t db,   \
                                              int accumulate) {                            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                            \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "               \
                 "{" REGS "}, " DA ", " DB ", p, 1, 1, 0, 1;\n}\n"                         \
                 : __VA_ARGS__                                                             \
                 : "l"(da), "l"(db), "r"(accumulate));                                     \
  }
TILED_WGMMA(64, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31", "%32", "%33", "%34",
            TILED_ACC4(0), TILED_ACC4(1), TILED_ACC4(2), TILED_ACC4(3), TILED_ACC4(4), TILED_ACC4(5), TILED_ACC4(6), TILED_ACC4(7))
TILED_WGMMA(128, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63", "%64", "%65", "%66",
            TILED_ACC4(0), TILED_ACC4(1), TILED_ACC4(2), TILED_ACC4(3), TILED_ACC4(4), TILED_ACC4(5), TILED_ACC4(6), TILED_ACC4(7), TILED_ACC4(8), TILED_ACC4(9), TILED_ACC4(10), TILED_ACC4(11), TILED_ACC4(12), TILED_ACC4(13), TILED_ACC4(14), TILED_ACC4(15))
#undef TILED_WGMMA
#undef TILED_ACC4

// ---------------------------------------------------------------------------
// the products' epilogues
// ---------------------------------------------------------------------------

// What a product does with its tile: EPI_STORE writes S = X W (float32, rows
// of ldc); EPI_MEM (N = D <= EPI_MAX) writes mem = relu(LN(S + sp_i + tp_j))
// in the operand type, zero to LDM; EPI_EDGE (N = E <= EPI_MAX) writes
// edge' = LN(edge + relu(LN(S + be))); EPI_LOGITS (the key product, heads
// of DH columns inside a tile) writes l[p][h] = q[target][h] . k[p][h] *
// scale, masked sources MASKED, and no k.
template <typename WT, typename EdgeT>
struct EpiArgs {
  float* c;
  long long ldc;
  WT* mem;
  const float* sp;
  const float* tp;
  const EdgeT* edge;
  float* edge_out;
  VecsT<WT> v;
  int n;
  const float* q;               // EPI_LOGITS: q [B N, D], the source mask, the logits
  const unsigned char* mask;
  float* logits;
  float scale;
};

// One row's epilogue from its W values x[] held by G lanes (value u of this
// lane is column col[u]; on[u] says col[u] < W): the LayerNorm steps of EPI
// and the row's write. Every lane of the G runs the shuffles; `ok` guards
// the loads and stores of a row past the end.
template <int EPI, int W, int G, int U, typename WT, typename EdgeT>
__device__ __forceinline__ void epilogue_row(float* x, const int* col, const bool* on,
                                             long long p, bool ok,
                                             const EpiArgs<WT, EdgeT>& ep) {
  auto ln = [&](const WT* g, const WT* b) {
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) s += on[u] ? x[u] : 0.f;
    const float mean = group_sum<G>(s) * (1.f / W);
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (on[u]) {
        const float d = x[u] - mean;
        sq = fmaf(d, d, sq);
      }
    const float inv = rsqrtf(group_sum<G>(sq) * (1.f / W) + LN_EPS);
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = on[u] ? (x[u] - mean) * inv * to_f(g[col[u]]) + to_f(b[col[u]]) : 0.f;
  };
  if constexpr (EPI == EPI_MEM) {
    const long long ti = ok ? tok_source(p, ep.n) : 0, tj = ok ? tok_target(p, ep.n) : 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (on[u]) x[u] += ok ? ep.sp[ti * W + col[u]] + ep.tp[tj * W + col[u]] : 0.f;
    ln(ep.v.ln_m_g, ep.v.ln_m_b);
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = fmaxf(x[u], 0.f);   // 0 past W
  } else if constexpr (EPI == EPI_EDGE) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (on[u]) x[u] += to_f(ep.v.be[col[u]]);
    ln(ep.v.ln_e1_g, ep.v.ln_e1_b);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (on[u]) x[u] = fmaxf(x[u], 0.f) + (ok ? to_f(ep.edge[p * W + col[u]]) : 0.f);
    ln(ep.v.ln_e2_g, ep.v.ln_e2_b);
    if (ok) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (on[u]) ep.edge_out[p * W + col[u]] = x[u];
    }
  }
}

// ---------------------------------------------------------------------------
// the float32 product: S[rows, N] = X[rows, K] W[K, N], register-tiled FMA
// ---------------------------------------------------------------------------

// A_VEC: X's rows (lda) are whole 16-byte pieces. LDM: the memory rows of
// EPI_MEM.
template <int K, int N, int BN, bool A_VEC, int EPI, int LDM, typename EdgeT, int DH = 0>
__global__ void __launch_bounds__(F_NT, BN == 64 ? 3 : 2)
product_f32(const float* __restrict__ a, long long lda, const float* __restrict__ w,
            long long rows, EpiArgs<float, EdgeT> ep) {
  constexpr int KT = (K + F_BK - 1) / F_BK;
  constexpr int NTL = (N + BN - 1) / BN;
  constexpr int NG = BN / 64;        // a thread's groups of 4 adjacent columns
  constexpr int CV = 4 * NG;         // its columns
  constexpr int F_STAGE = f_stage<BN>();
  constexpr bool W_VEC = N % 4 == 0;
  static_assert(BN == 64 || BN == 128, "tiles of 64 or 128 columns");
  static_assert(EPI == EPI_STORE || EPI == EPI_LOGITS || N <= BN,
                "an epilogue LayerNorm needs the whole row");
  static_assert(EPI != EPI_LOGITS || (DH >= 1 && 4 % DH == 0), "a head inside 4 columns");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int mtiles = (int)((rows + BM - 1) / BM);
  int mt, nt;
  tile_of(blockIdx.x, mtiles, NTL, mt, nt);
  const long long m0 = (long long)mt * BM;
  const int n0 = nt * BN;

  auto load = [&](int kt, int s) {
    float* As = sm + s * F_STAGE;
    float* Ws = As + BM * F_LDA;
    const int k0 = kt * F_BK;
    if constexpr (A_VEC) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {   // 128 rows x 4 pieces
        const int id = tid + x * F_NT, r = id >> 2, kq = (id & 3) * 4;
        const long long row = m0 + r;
        const int k = k0 + kq;
        const int bytes = row < rows ? max(0, min(16, (K - k) * 4)) : 0;
        cp_async16_n(As + r * F_LDA + kq, bytes ? a + row * lda + k : a, bytes);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) {   // 128 rows x 16 values
        const int id = tid + x * F_NT, r = id >> 4, kk = id & 15;
        const long long row = m0 + r;
        const bool ok = row < rows && k0 + kk < K;
        cp_async4(As + r * F_LDA + kk, ok ? a + row * lda + k0 + kk : a, ok ? 4 : 0);
      }
    }
    if constexpr (W_VEC) {
#pragma unroll
      for (int x = 0; x < NG; ++x) {   // 16 k x BN / 4 pieces
        const int id = tid + x * F_NT, k = id / (BN / 4), nq = (id % (BN / 4)) * 4;
        const int n = n0 + nq;
        const int bytes = k0 + k < K ? max(0, min(16, (N - n) * 4)) : 0;
        cp_async16_n(Ws + k * BN + nq, bytes ? w + (size_t)(k0 + k) * N + n : w, bytes);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 4 * NG; ++x) {   // 16 k x BN values
        const int id = tid + x * F_NT, k = id / BN, nn = id % BN;
        const bool ok = k0 + k < K && n0 + nn < N;
        cp_async4(Ws + k * BN + nn, ok ? w + (size_t)(k0 + k) * N + n0 + nn : w, ok ? 4 : 0);
      }
    }
  };

  float acc[8][CV];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();   // stage kt landed for every thread; stage kt - 1 is free
    if (kt + F_STAGES - 1 < KT) load(kt + F_STAGES - 1, (kt + F_STAGES - 1) % F_STAGES);
    cp_async_commit();
    const float* As = sm + (kt % F_STAGES) * F_STAGE;
    const float* Ws = As + BM * F_LDA;
#pragma unroll
    for (int kk = 0; kk < F_BK; kk += 2) {
      float2 av[8];   // two k at a time: 16 registers of X, 8 of W
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        av[r] = *reinterpret_cast<const float2*>(As + (ty * 4 + r) * F_LDA + kk);
        av[4 + r] = *reinterpret_cast<const float2*>(As + (64 + ty * 4 + r) * F_LDA + kk);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float wv[CV];
#pragma unroll
        for (int g = 0; g < NG; ++g) load_row<4>(Ws + (kk + q) * BN + g * 64 + tx * 4, wv + 4 * g);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x = q == 0 ? av[r].x : av[r].y;
#pragma unroll
          for (int c = 0; c < CV; ++c) acc[r][c] = fmaf(x, wv[c], acc[r][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // value (r, c) is row m0 + (r < 4 ? 0 : 64) + ty*4 + r % 4, column
  // n0 + (c / 4) 64 + tx*4 + c % 4
  int col[CV];
  bool on[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    col[c] = n0 + (c >> 2) * 64 + tx * 4 + (c & 3);
    on[c] = col[c] < N;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long p = m0 + (r >> 2) * 64 + ty * 4 + (r & 3);
    const bool ok = p < rows;
    if constexpr (EPI == EPI_LOGITS) {
      if (ok) {
        const float* qr = ep.q + tok_target(p, ep.n) * N;
        const bool key_on = ep.mask[tok_source(p, ep.n)];
#pragma unroll
        for (int u = 0; u < CV; u += DH) {
          if (col[u] < N) {
            float a = 0.f;
#pragma unroll
            for (int d = 0; d < DH; ++d) a = fmaf(qr[col[u] + d], acc[r][u + d], a);
            ep.logits[p * (N / DH) + col[u] / DH] = key_on ? a * ep.scale : MASKED;
          }
        }
      }
    } else if constexpr (EPI == EPI_STORE) {
      if (ok) {
#pragma unroll
        for (int h = 0; h < NG; ++h) {
          const int c0 = col[4 * h];
          float* dst = ep.c + p * ep.ldc + c0;
          if (N % 4 == 0 && c0 + 3 < N) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c0 + u < N) dst[u] = acc[r][4 * h + u];
          }
        }
      }
    } else {
      epilogue_row<EPI, N, 16, CV>(acc[r], col, on, p, ok, ep);
      if constexpr (EPI == EPI_MEM) {
        if (ok) {
#pragma unroll
          for (int h = 0; h < NG; ++h) {
            const int c0 = col[4 * h];
            if (c0 < LDM)
              *reinterpret_cast<float4*>(ep.mem + p * LDM + c0) = make_float4(
                  acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 product on the tensor cores
// ---------------------------------------------------------------------------

// W_TMA: W's rows are whole 16-byte pieces (N % 8 == 0): TMA; else the
// producer's element copies. X (tma_a) always arrives by TMA: its rows are
// the edge's where they are whole 16-byte pieces, else the cast copy's.
template <int K, int N, int BN, bool W_TMA, int EPI, int LDM, typename EdgeT, int DH = 0>
__global__ void __launch_bounds__(H_NT, 1)
product_bf16(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
             const bf16* __restrict__ w, long long rows, EpiArgs<bf16, EdgeT> ep) {
  constexpr int KT = (K + H_BK - 1) / H_BK;
  constexpr int NTL = (N + BN - 1) / BN;
  constexpr int STAGE = h_stage<BN>();
  constexpr int NG = BN / 8;   // 8-column groups of the accumulator
  static_assert(BN == 64 || BN == 128, "tiles of 64 or 128 columns");
  static_assert(EPI == EPI_STORE || EPI == EPI_LOGITS || N <= BN,
                "an epilogue LayerNorm needs the whole row");
  static_assert(EPI != EPI_LOGITS || (DH >= 1 && BN % DH == 0 && (DH < 8 || DH % 8 == 0)),
                "no head straddles two tiles");
  // the stages 1 KB aligned by hand (an aligned extern declaration would pad
  // every kernel's static shared memory of the library to its alignment)
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t full[H_STAGES], empty[H_STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~(uintptr_t)1023);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int mtiles = (int)((rows + BM - 1) / BM);
  int mt, nt;
  tile_of(blockIdx.x, mtiles, NTL, mt, nt);
  const long long m0 = (long long)mt * BM;
  const int n0 = nt * BN;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < H_STAGES; ++s) {
      mbar_init(&full[s], 128);   // every producer thread arrives
      mbar_init(&empty[s], 8);    // every consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup ----
#pragma unroll 1
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % H_STAGES, round = kt / H_STAGES;
      if (kt >= H_STAGES) mbar_wait(&empty[s], (round - 1) & 1);
      unsigned char* As = smem + s * STAGE;
      unsigned char* Ws = As + H_A_BYTES;
      if (tid == 0) {
        mbar_expect_tx(&full[s], H_A_BYTES + (W_TMA ? H_BK * BN * 2 : 0));
        tma_load_2d(As, &tma_a, kt * H_BK, (int)m0, &full[s]);
        if constexpr (W_TMA) {
#pragma unroll
          for (int g = 0; g < BN / 64; ++g)
            tma_load_2d(Ws + g * H_W_BOX, &tma_w, n0 + g * 64, kt * H_BK, &full[s]);
        }
      }
      if constexpr (!W_TMA) {
        // 16-byte pieces of 8 columns of one k row, into the swizzled layout:
        // every load of the thread's pieces issued before the first store
        // (32-bit loads where a row is a whole number of 4 bytes)
        constexpr int CH = H_BK * BN / 8 / 128;   // pieces a thread
        uint32_t e[CH][4];
#pragma unroll
        for (int x = 0; x < CH; ++x) {
          const int id = tid + x * 128, kr = id / (BN / 8), cj = id % (BN / 8);
          const int k = kt * H_BK + kr, nb = n0 + cj * 8;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if constexpr (N % 2 == 0) {
              const unsigned int* wp =
                  reinterpret_cast<const unsigned int*>(w + (size_t)k * N + nb);
              e[x][u] = k < K && nb + 2 * u < N ? __ldg(wp + u) : 0u;
            } else {
              const unsigned short* wb = reinterpret_cast<const unsigned short*>(w) + (size_t)k * N;
              const uint32_t lo = k < K && nb + 2 * u < N ? __ldg(wb + nb + 2 * u) : 0u;
              const uint32_t hi = k < K && nb + 2 * u + 1 < N ? __ldg(wb + nb + 2 * u + 1) : 0u;
              e[x][u] = lo | (hi << 16);
            }
          }
        }
#pragma unroll
        for (int x = 0; x < CH; ++x) {
          const int id = tid + x * 128, kr = id / (BN / 8), cj = id % (BN / 8);
          *reinterpret_cast<uint4*>(Ws + (cj >> 3) * H_W_BOX + kr * 128 +
                                    (((cj & 7) ^ (kr & 7)) << 4)) =
              make_uint4(e[x][0], e[x][1], e[x][2], e[x][3]);
        }
        fence_proxy_async_smem();
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 (wg - 1) of the tile ----
  const int cw = wg - 1;
  float acc[NG][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % H_STAGES, round = kt / H_STAGES;
    mbar_wait(&full[s], round & 1);
    const unsigned char* As = smem + s * STAGE + cw * 64 * 128;
    const unsigned char* Ws = smem + s * STAGE + H_A_BYTES;
    const uint64_t da = desc_sw128(smem_u32(As), 16, 1024);
    const uint64_t db = desc_sw128(smem_u32(Ws), W_LBO, W_SBO);
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][e])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < H_BK / 16; ++ks)   // 32 bytes of a row, 16 k rows of W a step
      wgmma_tn<BN>(acc, da + (uint64_t)(ks * 2), db + (uint64_t)(ks * 128), kt > 0 || ks > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][e])::"memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // value (i, e): row m0 + 64 cw + 16 warp + lane / 4 (+ 8 for e >= 2),
  // column n0 + 8 i + 2 (lane % 4) + e % 2
  const int q2 = (lane & 3) * 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long p = m0 + cw * 64 + warp * 16 + (lane >> 2) + hh * 8;
    const bool ok = p < rows;
    if constexpr (EPI == EPI_LOGITS) {
      // q . k per head: a lane's 2 columns, then its quad's 8 (DH >= 8: an
      // 8-column group lies in one head), then the head's groups in order
      const float* qr = ep.q + (ok ? tok_target(p, ep.n) : 0) * N;
      const bool key_on = ok && ep.mask[tok_source(p, ep.n)];
      float part[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int c = n0 + i * 8 + q2;
        const float q0 = ok && c < N ? qr[c] : 0.f, q1 = ok && c + 1 < N ? qr[c + 1] : 0.f;
        if constexpr (DH == 1) {
          if (ok && c < N) ep.logits[p * N + c] = key_on ? acc[i][2 * hh] * q0 * ep.scale : MASKED;
          if (ok && c + 1 < N)
            ep.logits[p * N + c + 1] = key_on ? acc[i][2 * hh + 1] * q1 * ep.scale : MASKED;
        } else {
          part[i] = fmaf(acc[i][2 * hh + 1], q1, acc[i][2 * hh] * q0);
          if constexpr (DH == 2) {
            if (ok && c < N) ep.logits[p * (N / 2) + c / 2] = key_on ? part[i] * ep.scale : MASKED;
          } else if constexpr (DH == 4) {
            part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
            if (ok && c < N && (lane & 1) == 0)
              ep.logits[p * (N / 4) + c / 4] = key_on ? part[i] * ep.scale : MASKED;
          } else {
            part[i] = group_sum<4>(part[i]);
          }
        }
      }
      if constexpr (DH >= 8) {
#pragma unroll
        for (int hl = 0; hl < BN / DH; ++hl) {
          float a = 0.f;
#pragma unroll
          for (int i = hl * (DH / 8); i < (hl + 1) * (DH / 8); ++i) a += part[i];
          const int h = (n0 + hl * DH) / DH;
          if (ok && (lane & 3) == 0 && n0 + hl * DH < N)
            ep.logits[p * (N / DH) + h] = key_on ? a * ep.scale : MASKED;
        }
      }
    } else if constexpr (EPI == EPI_STORE) {
      if (ok) {
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int c = n0 + i * 8 + q2;
          float* dst = ep.c + p * ep.ldc + c;
          if (N % 2 == 0 && c + 1 < N) {
            *reinterpret_cast<float2*>(dst) = make_float2(acc[i][2 * hh], acc[i][2 * hh + 1]);
          } else {
            if (c < N) dst[0] = acc[i][2 * hh];
            if (c + 1 < N) dst[1] = acc[i][2 * hh + 1];
          }
        }
      }
    } else {
      float x[2 * NG];
      int col[2 * NG];
      bool on[2 * NG];
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[2 * i + e] = acc[i][2 * hh + e];
          col[2 * i + e] = i * 8 + q2 + e;
          on[2 * i + e] = col[2 * i + e] < N;
        }
      epilogue_row<EPI, N, 4, 2 * NG>(x, col, on, p, ok, ep);
      if constexpr (EPI == EPI_MEM) {
        if (ok) {
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const int c = i * 8 + q2;
            if (c < LDM)
              *reinterpret_cast<__nv_bfloat162*>(ep.mem + p * LDM + c) =
                  __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// row passes: a warp a row where a row is wider than a tile's
// ---------------------------------------------------------------------------

// Two-pass LayerNorm of a W-wide row held by a warp: lane l holds columns
// l, l + 32, ... in x[0], x[1], ...; up to LN_REG_MAX values a lane (2,048
// wide), so that a row pass keeps many loads in flight.
template <int W, typename WT>
__device__ __forceinline__ void ln_warp(float* x, const WT* __restrict__ g,
                                        const WT* __restrict__ b, int lane) {
  constexpr int CP = (W + 31) / 32;
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < CP; ++m)
    if (W % 32 == 0 || lane + 32 * m < W) s += x[m];
  const float mean = group_sum<32>(s) * (1.f / W);
  float sq = 0.f;
#pragma unroll
  for (int m = 0; m < CP; ++m)
    if (W % 32 == 0 || lane + 32 * m < W) {
      const float d = x[m] - mean;
      sq = fmaf(d, d, sq);
    }
  const float inv = rsqrtf(group_sum<32>(sq) * (1.f / W) + LN_EPS);
#pragma unroll
  for (int m = 0; m < CP; ++m) {
    const int c = lane + 32 * m;
    if (W % 32 == 0 || c < W) x[m] = (x[m] - mean) * inv * to_f(g[c]) + to_f(b[c]);
  }
}

// The mean and 1 / sqrt(var + eps) of a W-wide row in memory, as ln_warp
// computes them (the same sums in the same order).
template <int W>
__device__ __forceinline__ void row_stats(const float* row, int lane, float& mean, float& inv) {
  float s = 0.f;
  for (int c = lane; c < W; c += 32) s += row[c];
  mean = group_sum<32>(s) * (1.f / W);
  float sq = 0.f;
  for (int c = lane; c < W; c += 32) {
    const float d = row[c] - mean;
    sq = fmaf(d, d, sq);
  }
  inv = rsqrtf(group_sum<32>(sq) * (1.f / W) + LN_EPS);
}

// mem[p] = relu(LN(S[p] + sp[source] + tp[target])) in the operand type,
// zero from D to LDM. Registers up to 2,048 wide, else in place over S.
template <class S, typename WT, int LDS, int LDM>
__global__ void __launch_bounds__(P_NT)
mem_pass(float* __restrict__ s_rows, const float* __restrict__ sp, const float* __restrict__ tp,
         VecsT<WT> v, WT* __restrict__ mem, long long rows, int n) {
  constexpr int D = S::D, CD = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * (P_NT / 32) + (threadIdx.x >> 5);
  if (p >= rows) return;
  const long long ti = tok_source(p, n), tj = tok_target(p, n);
  float* row = s_rows + p * LDS;
  WT* out = mem + p * LDM;
  if constexpr (CD <= LN_REG_MAX) {
    float x[CD];
#pragma unroll
    for (int m = 0; m < CD; ++m) {
      const int c = lane + 32 * m;
      x[m] = c < D ? row[c] + sp[ti * D + c] + tp[tj * D + c] : 0.f;
    }
    ln_warp<D>(x, v.ln_m_g, v.ln_m_b, lane);
#pragma unroll
    for (int m = 0; m < CD; ++m) {
      const int c = lane + 32 * m;
      if (c < D) out[c] = to_op<WT>(fmaxf(x[m], 0.f));
    }
  } else {
    for (int c = lane; c < D; c += 32) row[c] += sp[ti * D + c] + tp[tj * D + c];
    float mean, inv;
    row_stats<D>(row, lane, mean, inv);
    for (int c = lane; c < D; c += 32)
      out[c] = to_op<WT>(fmaxf((row[c] - mean) * inv * to_f(v.ln_m_g[c]) + to_f(v.ln_m_b[c]), 0.f));
  }
  for (int c = D + lane; c < LDM; c += 32) out[c] = to_op<WT>(0.f);
}

// edge'[p] = LN(edge[p] + relu(LN(S[p] + be))).
template <class S, typename WT, typename EdgeT, int LDS>
__global__ void __launch_bounds__(P_NT)
edge_pass(float* __restrict__ s_rows, const EdgeT* __restrict__ edge, VecsT<WT> v,
          float* __restrict__ edge_out, long long rows) {
  constexpr int E = S::E, CE = (E + 31) / 32;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * (P_NT / 32) + (threadIdx.x >> 5);
  if (p >= rows) return;
  float* row = s_rows + p * LDS;
  const EdgeT* e_in = edge + p * E;
  float* e_out = edge_out + p * E;
  if constexpr (CE <= LN_REG_MAX) {
    float x[CE];
#pragma unroll
    for (int m = 0; m < CE; ++m) {
      const int c = lane + 32 * m;
      x[m] = c < E ? row[c] + to_f(v.be[c]) : 0.f;
    }
    ln_warp<E>(x, v.ln_e1_g, v.ln_e1_b, lane);
#pragma unroll
    for (int m = 0; m < CE; ++m) {
      const int c = lane + 32 * m;
      if (c < E) x[m] = fmaxf(x[m], 0.f) + to_f(e_in[c]);
    }
    ln_warp<E>(x, v.ln_e2_g, v.ln_e2_b, lane);
#pragma unroll
    for (int m = 0; m < CE; ++m) {
      const int c = lane + 32 * m;
      if (c < E) e_out[c] = x[m];
    }
  } else {
    for (int c = lane; c < E; c += 32) row[c] += to_f(v.be[c]);
    float mean, inv;
    row_stats<E>(row, lane, mean, inv);
    for (int c = lane; c < E; c += 32)
      row[c] = fmaxf((row[c] - mean) * inv * to_f(v.ln_e1_g[c]) + to_f(v.ln_e1_b[c]), 0.f) +
               to_f(e_in[c]);
    row_stats<E>(row, lane, mean, inv);
    for (int c = lane; c < E; c += 32)
      e_out[c] = (row[c] - mean) * inv * to_f(v.ln_e2_g[c]) + to_f(v.ln_e2_b[c]);
  }
}

// The edge as the bf16 products' operand: x[p] = bf16(edge[p]), zero from E
// to LDX (with write_x), and the bf16 input edge out as float32 (with
// write_out).
template <int E, int LDX, typename EdgeT>
__global__ void __launch_bounds__(P_NT)
cast_pass(const EdgeT* __restrict__ edge, bf16* __restrict__ x, float* __restrict__ edge_out,
          long long rows, int write_x, int write_out) {
  const long long total = rows * LDX;
  for (long long idx = (long long)blockIdx.x * P_NT + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * P_NT) {
    const long long p = idx / LDX;
    const int c = (int)(idx - p * LDX);
    const float val = c < E ? to_f(edge[p * E + c]) : 0.f;
    if (write_x) x[idx] = __float2bfloat16_rn(val);
    if (write_out && c < E) edge_out[p * E + c] = val;
  }
}

// Unfolded logits: l[p][h] = q[target][h] . k[p][h] / sqrt(dh), masked
// sources MASKED. A thread a (pair, head) below a head width of 32, a warp
// above it.
template <class S, int LDS>
__global__ void __launch_bounds__(P_NT)
logits_pass(const float* __restrict__ k_rows, const float* __restrict__ q,
            const unsigned char* __restrict__ mask, float* __restrict__ logits, long long rows,
            int n) {
  constexpr int D = S::D, NH = S::NH, DH = S::DH;
  if constexpr (DH < 32) {
    const long long idx = (long long)blockIdx.x * P_NT + threadIdx.x;
    if (idx >= rows * NH) return;
    const long long p = (unsigned long long)idx / NH;
    const int h = (int)(idx - p * NH);
    const float* kr = k_rows + p * LDS + h * DH;
    const float* qr = q + tok_target(p, n) * D + h * DH;
    float a = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) a = fmaf(qr[d], kr[d], a);
    logits[idx] = mask[tok_source(p, n)] ? a * S::QK_SCALE : MASKED;
  } else {
    const long long idx = (long long)blockIdx.x * (P_NT / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (idx >= rows * NH) return;
    const long long p = idx / NH;
    const int h = (int)(idx - p * NH);
    const float* kr = k_rows + p * LDS + h * DH;
    const float* qr = q + tok_target(p, n) * D + h * DH;
    float a = 0.f;
    for (int d = lane; d < DH; d += 32) a = fmaf(qr[d], kr[d], a);
    a = group_sum<32>(a);
    if (lane == 0) logits[idx] = mask[tok_source(p, n)] ? a * S::QK_SCALE : MASKED;
  }
}

// The softmax statistics over the sources of each (target token, head):
// stats[t][h] = (max_i l, sum_i exp(l - max)); the consumers take the
// weights as exp(l - max) * (1 / sum).
template <int NH>
__global__ void __launch_bounds__(P_NT)
softmax_stats(const float* __restrict__ logits, float2* __restrict__ stats, int tokens, int n) {
  const int idx = blockIdx.x * P_NT + threadIdx.x;
  if (idx >= tokens * NH) return;
  const int t = idx / NH, h = idx - t * NH;
  const int b = t / n, j = t - b * n;
  // l of source i: logits[((b n + i) n + j) NH + h]
  const long long stride = (long long)n * NH;
  const float* l = logits + ((long long)b * n * n + j) * NH + h;
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, l[i * stride]);
  float sum = 0.f;
  for (int i = 0; i < n; ++i) sum += expf(l[i * stride] - mx);
  stats[idx] = make_float2(mx, sum);
}

// Unfolded attention sum: attn[t][c] = sum_i p[i][h(c)] v[i][c] with
// p = exp(l - max) * (1 / sum), a thread a (token, column), i from 0 up.
template <class S, int LDS>
__global__ void __launch_bounds__(P_NT)
attn_pass(const float* __restrict__ logits, const float2* __restrict__ stats,
          const float* __restrict__ v_rows, float* __restrict__ attn, int n) {
  constexpr int D = S::D, NH = S::NH, DH = S::DH;
  const int t = blockIdx.x;
  const int c = blockIdx.y * P_NT + threadIdx.x;
  if (c >= D) return;
  const int b = t / n, j = t - b * n;
  const int h = c / DH;
  const float2 st = stats[(long long)t * NH + h];
  const float inv = 1.f / st.y;
  float o = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const long long p = ((long long)b * n + i) * n + j;
    o = fmaf(expf(logits[p * NH + h] - st.x) * inv, v_rows[p * LDS + c], o);
  }
  attn[(long long)t * D + c] = o;
}

// ---------------------------------------------------------------------------
// the folded A's small products: C_x = A_x B_x for each x = blockIdx.x (a
// token (scene b, target j) for the logits and the context over the
// token's sources, a head for the folded keys and values over the tokens);
// a block a 64 x TN tile, k from 0 up in steps of Q_K. bind(x) sets the
// bases of x once.
// ---------------------------------------------------------------------------

// The tile's columns: 8, 16, 32 or 64, the least that holds `cols` (64 past).
template <int COLS>
__host__ __device__ constexpr int fold_tn() {
  return COLS <= 8 ? 8 : COLS <= 16 ? 16 : COLS <= 32 ? 32 : Q_T;
}

// logits of the fold: l[(b, i, j)][h] = mem[(b, i, j)] . qt[t][h] (qt is
// scaled), masked sources MASKED. m = source i, n = head h, k = column c.
template <class S, int LDM>
struct LogitsFold {
  static constexpr bool A_KFAST = true, B_KFAST = true, STORE_M_FAST = false;
  static constexpr int TN = fold_tn<S::NH>();
  const float* mem;
  const float* qt;
  const unsigned char* mask;
  float* logits;
  int n;
  const float *a_, *b_;
  float* c_;
  const unsigned char* m_;
  long long sam;
  __device__ int m_size() const { return n; }
  __device__ int n_size() const { return S::NH; }
  __device__ int k_size() const { return S::D; }
  __device__ void bind(int t) {
    const int b = t / n, j = t - b * n;
    const long long pair0 = (long long)b * n * n + j;   // pair (b, 0, j)
    a_ = mem + pair0 * LDM;
    b_ = qt + (long long)t * S::NH * S::D;
    c_ = logits + pair0 * S::NH;
    m_ = mask + (long long)b * n;
    sam = (long long)n * LDM;
  }
  __device__ float a(int i, int c) const { return a_[i * sam + c]; }
  __device__ float b(int c, int h) const { return b_[(long long)h * S::D + c]; }
  __device__ void store(int i, int h, float x) const {
    c_[(long long)i * n * S::NH + h] = m_[i] ? x : MASKED;
  }
};

// context of the fold: ctx[t][h][c] = sum_i p[(b, i, j)][h] mem[(b, i, j)][c],
// p = exp(l - max) * (1 / sum) (softmax_stats). m = column c, n = head h,
// k = source i.
template <class S, int LDM>
struct ContextFold {
  static constexpr bool A_KFAST = false, B_KFAST = false, STORE_M_FAST = true;
  static constexpr int TN = fold_tn<S::NH>();
  const float* logits;
  const float2* stats;
  const float* mem;
  float* ctx;
  int n;
  const float *a_, *b_;
  const float2* st_;
  float* c_;
  long long sak, sbk;
  __device__ int m_size() const { return S::D; }
  __device__ int n_size() const { return S::NH; }
  __device__ int k_size() const { return n; }
  __device__ void bind(int t) {
    const int b = t / n, j = t - b * n;
    const long long pair0 = (long long)b * n * n + j;
    a_ = mem + pair0 * LDM;
    b_ = logits + pair0 * S::NH;
    st_ = stats + (long long)t * S::NH;
    c_ = ctx + (long long)t * S::NH * S::D;
    sak = (long long)n * LDM;
    sbk = (long long)n * S::NH;
  }
  __device__ float a(int c, int i) const { return a_[i * sak + c]; }
  __device__ float b(int i, int h) const {   // the softmax weight p[i][h]
    const float2 st = st_[h];
    return expf(b_[i * sbk + h] - st.x) * (1.f / st.y);
  }
  __device__ void store(int c, int h, float x) const { c_[(long long)h * S::D + c] = x; }
};

// folded keys, head h: qt[t][h][c] = sum_d q[t][h dh + d] Wk[c][h dh + d] / sqrt(dh)
// (the logit of (i, j) for head h is mem[i, j] . qt[j][h]; bk cancels in the
// softmax). m = token t, n = column c, k = d.
template <class S>
struct FoldKeys {
  static constexpr bool A_KFAST = true, B_KFAST = true, STORE_M_FAST = false;
  static constexpr int TN = Q_T;
  const float* q;
  const float* wk;
  float* qt;
  int tokens;
  const float *a_, *b_;
  float* c_;
  __device__ int m_size() const { return tokens; }
  __device__ int n_size() const { return S::D; }
  __device__ int k_size() const { return S::DH; }
  __device__ void bind(int h) {
    a_ = q + h * S::DH;
    b_ = wk + h * S::DH;
    c_ = qt + (long long)h * S::D;
  }
  __device__ float a(int t, int d) const { return a_[(long long)t * S::D + d]; }
  __device__ float b(int d, int c) const { return b_[(long long)c * S::D + d]; }
  __device__ void store(int t, int c, float x) const {
    c_[(long long)t * S::NH * S::D + c] = x * S::QK_SCALE;
  }
};

// folded values, head h: attn[t][h dh + c] = ctx[t][h] . Wv[:, h dh + c]
// (out_proj_kernel adds bv). m = token t, n = column c of the head, k = row.
template <class S>
struct FoldValues {
  static constexpr bool A_KFAST = true, B_KFAST = false, STORE_M_FAST = false;
  static constexpr int TN = fold_tn<S::DH>();
  const float* ctx;
  const float* wv;
  float* attn;
  int tokens;
  const float *a_, *b_;
  float* c_;
  __device__ int m_size() const { return tokens; }
  __device__ int n_size() const { return S::DH; }
  __device__ int k_size() const { return S::D; }
  __device__ void bind(int h) {
    a_ = ctx + (long long)h * S::D;
    b_ = wv + h * S::DH;
    c_ = attn + h * S::DH;
  }
  __device__ float a(int t, int k) const { return a_[(long long)t * S::NH * S::D + k]; }
  __device__ float b(int k, int c) const { return b_[(long long)k * S::D + c]; }
  __device__ void store(int t, int c, float x) const { c_[(long long)t * S::D + c] = x; }
};

// Kernel A's per-token projections, x = 0, 1, 2: sp = node Wm_s,
// tp = node Wm_t + bm, q = node Wq + bq. m = token, n = column, k = row.
template <class S>
struct TokenProj {
  static constexpr bool A_KFAST = true, B_KFAST = false, STORE_M_FAST = false;
  static constexpr int TN = fold_tn<S::D>();
  const float* node;
  const float *w0, *w1, *w2;
  const float *bias1, *bias2;
  float *d0, *d1, *d2;
  int tokens;
  const float* w_;
  const float* bias_;
  float* dst_;
  __device__ int m_size() const { return tokens; }
  __device__ int n_size() const { return S::D; }
  __device__ int k_size() const { return S::D; }
  __device__ void bind(int x) {
    w_ = x == 0 ? w0 : x == 1 ? w1 : w2;
    bias_ = x == 0 ? nullptr : x == 1 ? bias1 : bias2;
    dst_ = x == 0 ? d0 : x == 1 ? d1 : d2;
  }
  __device__ float a(int t, int k) const { return node[(long long)t * S::D + k]; }
  __device__ float b(int k, int c) const { return w_[(long long)k * S::D + c]; }
  __device__ void store(int t, int c, float x) const {
    dst_[(long long)t * S::D + c] = bias_ == nullptr ? x : x + bias_[c];
  }
};

// Kernel A's output product: out = (attn + bv) Wo + bo.
template <class S>
struct OutProj {
  static constexpr bool A_KFAST = true, B_KFAST = false, STORE_M_FAST = false;
  static constexpr int TN = fold_tn<S::D>();
  const float* attn;
  const float* wo;
  const float* bv;
  const float* bo;
  float* out;
  int tokens;
  __device__ int m_size() const { return tokens; }
  __device__ int n_size() const { return S::D; }
  __device__ int k_size() const { return S::D; }
  __device__ void bind(int) {}
  __device__ float a(int t, int k) const { return attn[(long long)t * S::D + k] + bv[k]; }
  __device__ float b(int k, int c) const { return wo[(long long)k * S::D + c]; }
  __device__ void store(int t, int c, float x) const { out[(long long)t * S::D + c] = x + bo[c]; }
};

// Grid (x, ceil(M / 64), ceil(N / TN)); 256 threads, RM x RN outputs each.
template <class Op>
__global__ void __launch_bounds__(256, 2)
token_product(Op op) {
  constexpr int TM = Q_T, TN = Op::TN;
  constexpr int RN = TN >= 16 ? 4 : 2, TX = TN / RN, TY = 256 / TX, RM = TM / TY;
  static_assert(RM >= 1 && RM * TY == TM, "the threads cover the tile's rows");
  // the two operand tiles; after the last step, the output tile [TN][TM + 1]
  // where the op stores rows m fastest (its columns lie TM apart in memory)
  __shared__ __align__(16) float sm[Q_K * (TM + 4) + Q_K * (TN + 4)];
  static_assert(TN * (TM + 1) <= Q_K * (TM + 4) + Q_K * (TN + 4), "the output tile fits");
  float (*As)[TM + 4] = reinterpret_cast<float (*)[TM + 4]>(sm);
  float (*Bs)[TN + 4] = reinterpret_cast<float (*)[TN + 4]>(sm + Q_K * (TM + 4));
  op.bind(blockIdx.x);
  const int m0 = blockIdx.y * TM, n0 = blockIdx.z * TN;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int M = op.m_size(), N = op.n_size(), K = op.k_size();
  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
  // the next step's values are fetched into registers while the current
  // step's tile is multiplied out of shared memory
  constexpr int PA = Q_K * TM / 256, PB = (Q_K * TN + 255) / 256;
  float ra[PA], rb[PB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int x = 0; x < PA; ++x) {
      const int id = tid + x * 256;
      const int k = Op::A_KFAST ? id % Q_K : id / TM, m = Op::A_KFAST ? id / Q_K : id % TM;
      ra[x] = m0 + m < M && k0 + k < K ? op.a(m0 + m, k0 + k) : 0.f;
    }
#pragma unroll
    for (int x = 0; x < PB; ++x) {
      const int id = tid + x * 256;
      const int k = Op::B_KFAST ? id % Q_K : id / TN, nn = Op::B_KFAST ? id / Q_K : id % TN;
      rb[x] = id < Q_K * TN && n0 + nn < N && k0 + k < K ? op.b(k0 + k, n0 + nn) : 0.f;
    }
  };
  fetch(0);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += Q_K) {
#pragma unroll
    for (int x = 0; x < PA; ++x) {
      const int id = tid + x * 256;
      const int k = Op::A_KFAST ? id % Q_K : id / TM, m = Op::A_KFAST ? id / Q_K : id % TM;
      As[k][m] = ra[x];
    }
#pragma unroll
    for (int x = 0; x < PB; ++x) {
      const int id = tid + x * 256;
      const int k = Op::B_KFAST ? id % Q_K : id / TN, nn = Op::B_KFAST ? id / Q_K : id % TN;
      if (id < Q_K * TN) Bs[k][nn] = rb[x];
    }
    __syncthreads();
    if (k0 + Q_K < K) fetch(k0 + Q_K);
#pragma unroll
    for (int k = 0; k < Q_K; ++k) {
      float av[RM], bv[RN];
      load_row<RM>(&As[k][ty * RM], av);
      load_row<RN>(&Bs[k][tx * RN], bv);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  if constexpr (Op::STORE_M_FAST) {
    float* Cs = sm;   // [TN][TM + 1]; the last step's barrier freed the tiles
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) Cs[(tx * RN + c) * (TM + 1) + ty * RM + r] = acc[r][c];
    __syncthreads();
    for (int idx = tid; idx < TM * TN; idx += 256) {
      const int m = m0 + idx % TM, nn = n0 + idx / TM;
      if (m < M && nn < N) op.store(m, nn, Cs[(idx / TM) * (TM + 1) + idx % TM]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int m = m0 + ty * RM + r, nn = n0 + tx * RN + c;
        if (m < M && nn < N) op.store(m, nn, acc[r][c]);
      }
  }
}

// The grid of a token product of M rows and N columns over `x` bases.
template <class Op>
inline dim3 token_grid(int x, int m, int nn) {
  return dim3((unsigned)x, (unsigned)((m + Q_T - 1) / Q_T), (unsigned)((nn + Op::TN - 1) / Op::TN));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (no link to libcuda); null where it has none.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D bf16 map of `outer` rows of `inner` values, rows `row_bytes` apart,
// boxes of box_inner x box_outer, 128B swizzle, out of range read as zero.
inline int make_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                    uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return ERR_TMA;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMA;
}

inline unsigned blocks_for(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

// One product S[rows, N] = X[rows, K] W[K, N] (float32) with epilogue EPI.
template <int K, int N, int BN, bool A_VEC, int EPI, int LDM, typename EdgeT, int DH>
int launch_f32(const float* a, long long lda, const float* w, long long rows,
               const EpiArgs<float, EdgeT>& ep, cudaStream_t s) {
  auto fn = product_f32<K, N, BN, A_VEC, EPI, LDM, EdgeT, DH>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, f_smem<BN>());
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (rows + BM - 1) / BM * ((N + BN - 1) / BN);
  fn<<<(unsigned)tiles, F_NT, f_smem<BN>(), s>>>(a, lda, w, rows, ep);
  return 0;
}

// The same on the tensor cores: X bf16 [rows, K] with rows lda apart (a
// whole number of 16 bytes), W bf16 [K, N].
template <int K, int N, int BN, int EPI, int LDM, typename EdgeT, int DH>
int launch_bf16(const bf16* a, long long lda, const bf16* w, long long rows,
                const EpiArgs<bf16, EdgeT>& ep, cudaStream_t s) {
  constexpr bool W_TMA = N % 8 == 0;
  CUtensorMap ma, mw;
  memset(&mw, 0, sizeof(mw));
  int err = make_map(&ma, a, K, rows, lda * 2, H_BK, BM);
  if (err == 0 && W_TMA) err = make_map(&mw, w, N, K, (uint64_t)N * 2, 64, H_BK);
  if (err != 0) return err;
  auto fn = product_bf16<K, N, BN, W_TMA, EPI, LDM, EdgeT, DH>;
  const cudaError_t cerr =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, h_smem<BN>());
  if (cerr != cudaSuccess) return (int)cerr;
  const long long tiles = (rows + BM - 1) / BM * ((N + BN - 1) / BN);
  fn<<<(unsigned)tiles, H_NT, h_smem<BN>(), s>>>(ma, mw, w, rows, ep);
  return 0;
}

// A_VEC: X's rows are whole 16-byte pieces (mem always, the edge where
// E % 4 == 0; float32 only: bf16 rows always are).
template <class L, int K, int N, int EPI, bool A_VEC, typename WT, typename EdgeT>
int product(const WT* a, long long lda, const WT* w, long long rows,
            const EpiArgs<WT, EdgeT>& ep, cudaStream_t s) {
  constexpr int DH = EPI == EPI_LOGITS ? L::DH : 0;
  constexpr int BN = N <= 64 ? 64 : 128;
  if constexpr (L::BF) {
    return launch_bf16<K, N, BN, EPI, L::LDM, EdgeT, DH>(a, lda, w, rows, ep, s);
  } else {
    return launch_f32<K, N, BN, A_VEC, EPI, L::LDM, EdgeT, DH>(a, lda, w, rows, ep, s);
  }
}

// Kernel A's per-token projections sp, tp, q [B N, D]: every token's sums
// run from k = 0 up, whatever tile it lands in.
template <class S>
void token_proj(const float* node, const float* wm_s, const float* wm_t, const float* wq,
                const Vecs& v, float* sp, float* tp, float* q, int tokens, cudaStream_t s) {
  TokenProj<S> op{};
  op.node = node, op.w0 = wm_s, op.w1 = wm_t, op.w2 = wq, op.bias1 = v.bm, op.bias2 = v.bq;
  op.d0 = sp, op.d1 = tp, op.d2 = q, op.tokens = tokens;
  token_product<<<token_grid<TokenProj<S>>(3, tokens, S::D), 256, 0, s>>>(op);
}

// Kernel A's out [B N, D] = (attn + bv) Wo + bo.
template <class S>
void out_proj(const float* attn, const float* wo, const Vecs& v, float* out, int tokens,
              cudaStream_t s) {
  OutProj<S> op{};
  op.attn = attn, op.wo = wo, op.bv = v.bv, op.bo = v.bo, op.out = out, op.tokens = tokens;
  token_product<<<token_grid<OutProj<S>>(1, tokens, S::D), 256, 0, s>>>(op);
}

// The folded keys qt [B N, NH, D] from q [B N, D] (kernel A's tiled route).
template <class S>
void fold_keys(const float* q, const float* wk, float* qt, int tokens, cudaStream_t s) {
  FoldKeys<S> op{};
  op.q = q, op.wk = wk, op.qt = qt, op.tokens = tokens;
  token_product<<<token_grid<FoldKeys<S>>(S::NH, tokens, S::D), 256, 0, s>>>(op);
}

// The folded values' product attn [B N, D] from ctx [B N, NH, D].
template <class S>
void fold_values(const float* ctx, const float* wv, float* attn, int tokens, cudaStream_t s) {
  FoldValues<S> op{};
  op.ctx = ctx, op.wv = wv, op.attn = attn, op.tokens = tokens;
  token_product<<<token_grid<FoldValues<S>>(S::NH, tokens, S::DH), 256, 0, s>>>(op);
}

// The pair steps of one call on `s`, between the per-token prologue (sp, tp
// and q, or the folded keys qt) and the output product: writes attn [B N, D]
// (unfolded; the attention sum, without bv) or ctx [B N, NH, D] (folded: the
// softmax-weighted memory per head), and edge' (update_edge) or the bf16
// input edge as float32 (write_cast). 0, a CUDA error or ERR_TMA.
template <class S, typename WT, typename EdgeT>
int run_pairs(const EdgeT* edge, const unsigned char* mask, const WT* wm_e, const WT* we,
              const WT* wk, const WT* wv, const float* sp, const float* tp, const float* q,
              const VecsT<WT>& v, float* attn, float* edge_out, unsigned char* scratch,
              int batch, int n, int update_edge, int write_cast, cudaStream_t s) {
  using L = Layout<S, WT>;
  constexpr int D = S::D, E = S::E, NH = S::NH, LDS = L::LDS, LDM = L::LDM;
  const long long rows = (long long)batch * n * n, tokens = (long long)batch * n;
  if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  float* Sb = reinterpret_cast<float*>(scratch);
  WT* M = reinterpret_cast<WT*>(scratch + ru256(rows * L::PAIR_S));
  float* Lg = reinterpret_cast<float*>(scratch + ru256(rows * L::PAIR_S) + ru256(rows * L::PAIR_M));
  float2* St = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(Lg) +
                                         ru256(rows * L::PAIR_L));
  const unsigned pass_rows = blocks_for(rows, P_NT / 32);
  int err = 0;

  // ---- mem = relu(LN(edge Wm_e + sp_i + tp_j)) ----
  const WT* x = reinterpret_cast<const WT*>(edge);
  long long ldx = E;
  if constexpr (L::BF) {
    constexpr bool CAST = !std::is_same<EdgeT, bf16>::value || E % 8 != 0;
    if (CAST || write_cast) {
      const long long need = (rows * LDM + P_NT - 1) / P_NT;
      cast_pass<E, LDM, EdgeT><<<(unsigned)(need < 132 * 16 ? need : 132 * 16), P_NT, 0, s>>>(
          edge, M, edge_out, rows, CAST ? 1 : 0,
          write_cast && std::is_same<EdgeT, bf16>::value ? 1 : 0);
    }
    if (CAST) {
      x = M;   // the memory rows overwrite it row by row, once each tile has read its own
      ldx = LDM;
    }
  }
  // the products that read no edge share their instantiation across edge types
  const EpiArgs<WT, WT> ep0{Sb, LDS, M, sp, tp, nullptr, nullptr, v, n};
  const EpiArgs<WT, EdgeT> ep{Sb, LDS, M, sp, tp, edge, edge_out, v, n};
  constexpr bool X_VEC = E % 4 == 0;
  if constexpr (L::EPI_MEM_LN) {
    err = product<L, E, D, EPI_MEM, X_VEC>(x, ldx, wm_e, rows, ep0, s);
  } else {
    err = product<L, E, D, EPI_STORE, X_VEC>(x, ldx, wm_e, rows, ep0, s);
    if (err == 0)
      mem_pass<S, WT, LDS, LDM><<<pass_rows, P_NT, 0, s>>>(Sb, sp, tp, v, M, rows, n);
  }
  if (err != 0) return err;

  // ---- edge' = LN(edge + relu(LN(mem We + be))) ----
  if (update_edge) {
    if constexpr (L::EPI_EDGE_LN) {
      err = product<L, D, E, EPI_EDGE, true>(M, LDM, we, rows, ep, s);
    } else {
      err = product<L, D, E, EPI_STORE, true>(M, LDM, we, rows, ep0, s);
      if (err == 0)
        edge_pass<S, WT, EdgeT, LDS><<<pass_rows, P_NT, 0, s>>>(Sb, edge, v, edge_out, rows);
    }
    if (err != 0) return err;
  }

  // ---- attention over the sources ----
  const unsigned stat_blocks = blocks_for(tokens * NH, P_NT);
  if constexpr (L::FOLD) {
    // q is qt [B N, NH, D]; attn receives ctx [B N, NH, D]
    LogitsFold<S, LDM> lf{};
    lf.mem = reinterpret_cast<const float*>(M), lf.qt = q, lf.mask = mask, lf.logits = Lg;
    lf.n = n;
    token_product<<<token_grid<LogitsFold<S, LDM>>((int)tokens, n, NH), 256, 0, s>>>(lf);
    softmax_stats<NH><<<stat_blocks, P_NT, 0, s>>>(Lg, St, (int)tokens, n);
    ContextFold<S, LDM> cf{};
    cf.logits = Lg, cf.stats = St, cf.mem = reinterpret_cast<const float*>(M), cf.ctx = attn;
    cf.n = n;
    token_product<<<token_grid<ContextFold<S, LDM>>((int)tokens, D, NH), 256, 0, s>>>(cf);
  } else {
    if constexpr (L::EPI_LOGITS_OK) {
      EpiArgs<WT, WT> epk = ep0;
      epk.q = q, epk.mask = mask, epk.logits = Lg, epk.scale = S::QK_SCALE;
      err = product<L, D, D, EPI_LOGITS, true>(M, LDM, wk, rows, epk, s);
      if (err != 0) return err;
    } else {
      err = product<L, D, D, EPI_STORE, true>(M, LDM, wk, rows, ep0, s);
      if (err != 0) return err;
      const unsigned lb =
          S::DH < 32 ? blocks_for(rows * NH, P_NT) : blocks_for(rows * NH, P_NT / 32);
      logits_pass<S, LDS><<<lb, P_NT, 0, s>>>(Sb, q, mask, Lg, rows, n);
    }
    softmax_stats<NH><<<stat_blocks, P_NT, 0, s>>>(Lg, St, (int)tokens, n);
    err = product<L, D, D, EPI_STORE, true>(M, LDM, wv, rows, ep0, s);
    if (err != 0) return err;
    attn_pass<S, LDS><<<dim3((unsigned)tokens, (D + P_NT - 1) / P_NT), P_NT, 0, s>>>(
        Lg, St, Sb, attn, n);
  }
  return 0;
}

// One of the call's products alone, S[rows, N] = X[rows, K] W[K, N] into c
// (rows of ldc floats): which = 0 the memory product (K = E, N = D), 1 the
// edge update (K = D, N = E), 2 a key or value product (K = D, N = D). For
// calibration and timing (tools/check_fusion_kernels.py); X's rows are lda
// values apart, a whole number of 16 bytes.
template <class S, typename WT>
int product_alone(int which, const WT* a, long long lda, const WT* w, float* c, long long ldc,
                  long long rows, cudaStream_t s) {
  using L = Layout<S, WT>;
  const EpiArgs<WT, WT> ep{c, ldc, nullptr, nullptr, nullptr, nullptr, nullptr, VecsT<WT>{}, 1};
  if (which == 0) return product<L, S::E, S::D, EPI_STORE, true>(a, lda, w, rows, ep, s);
  if (which == 1) return product<L, S::D, S::E, EPI_STORE, true>(a, lda, w, rows, ep, s);
  return product<L, S::D, S::D, EPI_STORE, true>(a, lda, w, rows, ep, s);
}

}  // namespace tiled
}  // namespace fusion
