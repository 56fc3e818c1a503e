// The tiled layout of the fused edge-attention kernels (sm_90a): the main
// kernel of both variants at every shape outside the resident layout
// (fusion_common.cuh's Widths::RESIDENT): widths above 128, widths that are
// not multiples of 16, and any head layout (a head width of 1 to D). Included
// by fusion_attention.cu (float32: plain FMA) and fusion_attention_bf16.cu
// (bf16 operands on the tensor cores, mma.sync m16n8k16, float32 sums).
//
// Replaces, as the resident kernels do, the TPU kernel
// mind_tpu/ops/fusion_attention.py::_kernel, here at the rest of its domain.
// It computes the pair the way that kernel does (k and v per pair, not
// folded): per chunk of TI = 8 sources and the block's TJ (scene, target)
// columns, R = 8 TJ rows,
//
//   X  <- edge chunk (operand type; zero past E, and for rows past the end)
//   S  <- X Wm_e                         mem = relu(LN(S + sp_i + tp_j + bm)) -> X
//   S  <- X We    (edge update)          edge' = LN(edge + relu(LN(S + be))) -> memory
//   S  <- X Wk                           logits[r][h] = q_j[h] . S[r][h] * scale
//   online softmax per (target, head) over the chunk's sources
//   S  <- X Wv                           O[j] = O[j] corr + sum_i p[i][j] S[i, j]
//
// and writes attn[j] = O[j] / sum_i p; fusion_common.cuh's per-token kernels
// give sp, tp, q before it and (attn + bv) Wo + bo after it. bk is never
// added: its logit term bk_h . q_h[j] is the same for every source and
// cancels in the softmax.
//
// What it does about the widths:
// - every product S[R][N] = X[R][K] W[K][N] streams W out of global memory
//   (L2) in slices of KS = 32 k by NC <= 128 columns, double-buffered in
//   shared memory (the next slice is loaded into registers while the current
//   one is multiplied), and goes over N in column tiles of NC; nothing of a
//   weight stays resident, so no width is bounded by the weights;
// - K is zero-padded to the product's quantum (4 in float32, 16 for
//   m16n8k16) in X and in the slice, so a padded k adds 0;
// - the pre-LayerNorm values of a product are staged in S (float32, R rows
//   of max(D, E)), and every LayerNorm is a warp's two-pass sum over its
//   row at the true width, a compile-time constant;
// - heads are any contiguous DH columns: the logit of (row, head) is one
//   thread's sum over its DH columns, and the attention sum one thread's per
//   (target, column); no head is padded, and the logits take the true head
//   width's scale;
// - the edge is read and written at its true width and stride: 16-byte loads
//   where a row is a whole number of 16-byte pieces (E * 4 or E * 2 bytes),
//   one element at a time otherwise;
// - a block takes TJ = 8, 4, 2 or 1 columns: the largest whose layout fits
//   the card's shared memory (256 wide: 8; 512 wide: 4; 768 wide in float32:
//   2; 2,048 wide: 1). A chunk is TI = 8 sources of them, so R = 8 TJ rows;
//   at R = 8 the bf16 product runs its m16n8k16 tiles with the upper 8 rows
//   absent (zero operands, results dropped);
// - where even one column's layout does not fit ("staged": float32 past
//   D = E ~ 2,750, bf16 past ~3,750, fewer with many heads), the block's
//   rows, q, the attention sum and the softmax state lie in a global scratch
//   that the caller allocates (Layout::SCRATCH_BYTES a block, for at most
//   GRID_CAP blocks that walk the columns in turn), read back through L1 and
//   L2; only the weight slices stay in shared memory, so a block's shared
//   memory is bounded whatever the width;
// - a LayerNorm runs in a warp's registers up to 512 wide (LN_REG_MAX values
//   a lane), and past that in passes over the staged row in S, so that no
//   register array grows with the width. Both take the same sums in the
//   same order.
//
// Bound: as the resident kernels, by operations in float32 and by bytes in
// bf16 up to 256 wide (by operations at 512 / 512 / 16 and above). The bound
// counted is fusion_attention.py::fused_edge_attention_flops / _bytes at the
// true widths. This layout is the simple form: k and v per pair in float32 too
// (the resident kernel A folds them), synchronous chunk loads and a
// block-wide barrier between the steps, and every chunk streams all its
// weights again; PERF.md gives its times.
//
// Every sum runs in an order that depends on neither the block nor the row a
// pair lands in, so a node computes in a batch of scenes what it computes
// alone, to the bit.

#pragma once

#include "fusion_common.cuh"

namespace fusion {
namespace tiled {

typedef __nv_bfloat16 bf16;

constexpr int NTT = 256;                 // threads a block: 8 warps
constexpr int NWT = NTT / 32;
constexpr int NC_MAX = 128;              // output columns of a tile
constexpr int KS = 32;                   // k of a weight slice
constexpr int BUDGET = 232448 - 1024;    // dynamic shared memory a block may take
constexpr int GRID_CAP = 264;            // blocks of a staged launch (2 an SM)
constexpr int LN_REG_MAX = 16;           // values a lane of a register LayerNorm

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Bytes of a block of tj columns (Layout's offsets, added up).
__host__ __device__ constexpr long long layout_bytes(int tj, int ldx_bytes, int lds,
                                                     int w_bytes, int d_o, int nh) {
  return round_up(8 * tj * ldx_bytes, 16) + 8LL * tj * lds * 4 + 2LL * w_bytes +
         2LL * tj * d_o * 4 + 8LL * tj * nh * 4 + 3LL * tj * nh * 4;
}

// The most columns (8, 4, 2 or 1) whose block fits BUDGET, or 0.
__host__ __device__ constexpr int shared_columns(int ldx_bytes, int lds, int w_bytes, int d_o,
                                                 int nh) {
  int tj = 8;
  while (tj > 0 && layout_bytes(tj, ldx_bytes, lds, w_bytes, d_o, nh) > BUDGET) tj /= 2;
  return tj;
}

// The block's layout (bytes) for the library's widths and weight type WT.
template <class S, typename WT>
struct Layout {
  static constexpr int D = S::D, E = S::E, NH = S::NH;
  static constexpr bool BF = sizeof(WT) == 2;
  static constexpr int KQ = BF ? 16 : 4;               // k quantum of a product
  static constexpr int DQ = round_up(D, KQ), EQ = round_up(E, KQ);
  static constexpr int XW = cmax(DQ, EQ);
  static constexpr int LDX = XW + (BF ? 8 : 4);        // X row (elements): +16 bytes
  static constexpr int LDS = round_up(cmax(D, E), 4) + 4;   // S row (floats)
  static constexpr int DO = round_up(D, 4);            // O and q rows (floats)
  static constexpr int LDW = KS + 8;                   // bf16 slice row [n][k]
  static constexpr int W_BYTES = BF ? NC_MAX * LDW * 2 : KS * NC_MAX * 4;
  static constexpr int XB = LDX * (int)sizeof(WT);    // X row (bytes)
  // columns a block in shared memory, or 0 where not even one fits
  static constexpr int TJ_SHARED = shared_columns(XB, LDS, W_BYTES, DO, NH);
  static constexpr bool STAGED = TJ_SHARED == 0;      // the rows in global scratch
  static constexpr int TJ = STAGED ? 1 : TJ_SHARED;
  static constexpr int R = TI * TJ;                    // rows of a chunk: source-major
  static constexpr int OFF_X = 0;                                  // [R][LDX] operand
  static constexpr int OFF_S = round_up(R * LDX * (int)sizeof(WT), 16);   // [R][LDS]
  static constexpr int OFF_W = OFF_S + R * LDS * 4;                // 2 weight slices
  static constexpr int OFF_O = OFF_W + 2 * W_BYTES;                // [TJ][DO] sum p v
  static constexpr int OFF_Q = OFF_O + TJ * DO * 4;                // [TJ][DO] q
  static constexpr int OFF_L = OFF_Q + TJ * DO * 4;                // [R][NH] logits, p
  static constexpr int OFF_M = OFF_L + R * NH * 4;                 // [TJ][NH] running max
  static constexpr int OFF_SUM = OFF_M + TJ * NH * 4;              // [TJ][NH] running sum
  static constexpr int OFF_C = OFF_SUM + TJ * NH * 4;              // [TJ][NH] correction
  static constexpr int BLOCK_BYTES = OFF_C + TJ * NH * 4;
  static_assert(BLOCK_BYTES == layout_bytes(TJ, XB, LDS, W_BYTES, DO, NH),
                "the offsets add up to layout_bytes");
  // dynamic shared memory: the whole block, or (staged) the weight slices
  static constexpr int SMEM_BYTES = STAGED ? 2 * W_BYTES : BLOCK_BYTES;
  // global scratch a block (staged; its weight-slice bytes stay unused)
  static constexpr int SCRATCH_BYTES = STAGED ? round_up(BLOCK_BYTES, 256) : 0;
  static_assert(SMEM_BYTES <= BUDGET, "the layout must fit the H100's opt-in shared memory");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two-pass LayerNorm of a W-wide row held by a warp: lane l holds columns
// l, l + 32, ... in x[0], x[1], ...; the statistics divide by the true W.
// Up to LN_REG_MAX values a lane (W <= 512); row_stats below is the same
// arithmetic over a row in memory.
template <int W, typename WT>
__device__ __forceinline__ void ln_warp(float* x, const WT* __restrict__ g,
                                        const WT* __restrict__ b, int lane) {
  constexpr int CP = (W + 31) / 32;
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < CP; ++m)
    if (W % 32 == 0 || lane + 32 * m < W) s += x[m];
  const float mean = warp_sum(s) * (1.f / W);
  float sq = 0.f;
#pragma unroll
  for (int m = 0; m < CP; ++m)
    if (W % 32 == 0 || lane + 32 * m < W) {
      const float d = x[m] - mean;
      sq = fmaf(d, d, sq);
    }
  const float inv = rsqrtf(warp_sum(sq) * (1.f / W) + LN_EPS);
#pragma unroll
  for (int m = 0; m < CP; ++m) {
    const int c = lane + 32 * m;
    if (W % 32 == 0 || c < W) x[m] = (x[m] - mean) * inv * to_f(g[c]) + to_f(b[c]);
  }
}

// The mean and 1 / sqrt(var + eps) of a W-wide row in memory (shared or
// global), as ln_warp computes them: lane l sums columns l, l + 32, ... from
// the first up, the warp's lanes are summed by warp_sum, and each lane reads
// only the columns it wrote.
template <int W>
__device__ __forceinline__ void row_stats(const float* row, int lane, float& mean,
                                          float& inv) {
  float s = 0.f;
  for (int c = lane; c < W; c += 32) s += row[c];
  mean = warp_sum(s) * (1.f / W);
  float sq = 0.f;
  for (int c = lane; c < W; c += 32) {
    const float d = row[c] - mean;
    sq = fmaf(d, d, sq);
  }
  inv = rsqrtf(warp_sum(sq) * (1.f / W) + LN_EPS);
}

template <typename WT> __device__ __forceinline__ WT to_op(float x);
template <> __device__ __forceinline__ float to_op<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 to_op<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// S[r][n] = sum_{k < K} X[r][k] w[k][n] for the R rows of the chunk and
// n < N: float32, plain FMA. A lane holds TRW = R / 8 rows and NC / 32
// columns (lane, lane + 32, ...) of a tile; k runs from 0 up in every sum.
template <class L, int K, int N>
__device__ __forceinline__ void product(const float* X, const float* __restrict__ w, float* Sb,
                                        unsigned char* wbuf, int tid) {
  constexpr int R = L::R, LDX = L::LDX, LDS = L::LDS;
  constexpr int NC = cmin(NC_MAX, round_up(N, 32));
  constexpr int CPL = NC / 32;
  constexpr int TRW = R / NWT;
  constexpr int KP = round_up(K, 4);
  constexpr int NKS = (KP + KS - 1) / KS;
  constexpr int NCT = (N + NC - 1) / NC;
  constexpr int PER = KS * NC / NTT;        // slice values a thread stages
  static_assert(PER * NTT == KS * NC, "a slice is a whole number of values a thread");
  const int lane = tid & 31, wid = tid >> 5;
  float* Wsl = reinterpret_cast<float*>(wbuf);
  float pre[PER];
  auto fetch = [&](int sl) {
    const int n0 = (sl / NKS) * NC, k0 = (sl % NKS) * KS;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int idx = tid + m * NTT;
      const int k = k0 + idx / NC, n = n0 + idx % NC;
      pre[m] = k < K && n < N ? __ldg(w + (size_t)k * N + n) : 0.f;
    }
  };
  float acc[TRW][CPL];
  fetch(0);
#pragma unroll 1
  for (int sl = 0; sl < NCT * NKS; ++sl) {
    float* Ws = Wsl + (sl & 1) * (L::W_BYTES / 4);
#pragma unroll
    for (int m = 0; m < PER; ++m) Ws[tid + m * NTT] = pre[m];
    __syncthreads();
    if (sl + 1 < NCT * NKS) fetch(sl + 1);
    const int ks = sl % NKS, k0 = ks * KS;
    if (ks == 0) {
#pragma unroll
      for (int rr = 0; rr < TRW; ++rr)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[rr][c] = 0.f;
    }
    const float* xr = X + wid * TRW * LDX + k0;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 4) {
      if (KP % KS == 0 || k0 + kk < KP) {
        float4 a[TRW];
#pragma unroll
        for (int rr = 0; rr < TRW; ++rr)
          a[rr] = *reinterpret_cast<const float4*>(xr + rr * LDX + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float wv[CPL];
#pragma unroll
          for (int c = 0; c < CPL; ++c) wv[c] = Ws[(kk + q) * NC + lane + 32 * c];
#pragma unroll
          for (int rr = 0; rr < TRW; ++rr) {
            const float x = q == 0 ? a[rr].x : q == 1 ? a[rr].y : q == 2 ? a[rr].z : a[rr].w;
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[rr][c] = fmaf(x, wv[c], acc[rr][c]);
          }
        }
      }
    }
    if (ks == NKS - 1) {
      const int n0 = (sl / NKS) * NC;
#pragma unroll
      for (int rr = 0; rr < TRW; ++rr)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int n = n0 + lane + 32 * c;
          if (N % NC == 0 || n < N) Sb[(wid * TRW + rr) * LDS + n] = acc[rr][c];
        }
    }
  }
  __syncthreads();   // S complete, the slices free
}

// acc (+)= a[16 x 16] b[16 x 8], bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The same product with bf16 operands on the tensor cores: warp w takes the
// 16-row group w / WC and NC / WC columns of a tile (NTW 8-column mma
// tiles); a slice is staged transposed to [n][k], as the mma's column
// operand reads it. At R = 8 (a block of one column) the one row group's
// upper 8 rows are absent: their operands are zero and their results are
// not stored.
template <class L, int K, int N>
__device__ __forceinline__ void product(const bf16* X, const bf16* __restrict__ w, float* Sb,
                                        unsigned char* wbuf, int tid) {
  constexpr int R = L::R, LDX = L::LDX, LDS = L::LDS, LDW = L::LDW;
  constexpr int RG = (R + 15) / 16;          // 16-row groups
  constexpr bool HALF = R % 16 != 0;         // R = 8: rows 8-15 of the group absent
  static_assert(!HALF || R == 8, "a chunk is 8 rows or a multiple of 16");
  constexpr int WC = NWT / RG;               // warps along a tile's columns
  constexpr int NC = cmin(NC_MAX, round_up(N, 8 * WC));
  constexpr int NTW = NC / (8 * WC);
  constexpr int KP = round_up(K, 16);
  constexpr int NKS = (KP + KS - 1) / KS;
  constexpr int NCT = (N + NC - 1) / NC;
  constexpr int PER = KS * NC / NTT;
  static_assert(RG * WC == NWT && NTW >= 1, "the warps tile the chunk's rows and a tile");
  static_assert(PER * NTT == KS * NC, "a slice is a whole number of values a thread");
  const int lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = wid / WC, wc = wid % WC;
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w);
  unsigned short* Wt = reinterpret_cast<unsigned short*>(wbuf);
  unsigned short pre[PER];
  auto fetch = [&](int sl) {
    const int n0 = (sl / NKS) * NC, k0 = (sl % NKS) * KS;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int idx = tid + m * NTT;
      const int k = k0 + idx / NC, n = n0 + idx % NC;
      pre[m] = k < K && n < N ? __ldg(wb + (size_t)k * N + n) : (unsigned short)0;
    }
  };
  float acc[NTW][4];
  fetch(0);
#pragma unroll 1
  for (int sl = 0; sl < NCT * NKS; ++sl) {
    unsigned short* Ws = Wt + (sl & 1) * (L::W_BYTES / 2);
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int idx = tid + m * NTT;
      Ws[(idx % NC) * LDW + idx / NC] = pre[m];
    }
    __syncthreads();
    if (sl + 1 < NCT * NKS) fetch(sl + 1);
    const int ks = sl % NKS, k0 = ks * KS;
    if (ks == 0) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
    const bf16* xa = X + (rg * 16 + g) * LDX + k0 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      if (KP % KS == 0 || k0 + kk < KP) {
        const uint32_t a0 = ld32(xa + kk), a1 = HALF ? 0u : ld32(xa + 8 * LDX + kk);
        const uint32_t a2 = ld32(xa + kk + 8), a3 = HALF ? 0u : ld32(xa + 8 * LDX + kk + 8);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const unsigned short* wp = Ws + (wc * 8 * NTW + nt * 8 + g) * LDW + kk + 2 * t;
          mma_bf16(acc[nt], a0, a1, a2, a3, ld32(wp), ld32(wp + 8));
        }
      }
    }
    if (ks == NKS - 1) {
      const int n0 = (sl / NKS) * NC;
      const int r0 = rg * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int n = n0 + wc * 8 * NTW + nt * 8 + 2 * t;
        if (N % 2 == 0 && N % NC == 0) {
          *reinterpret_cast<float2*>(Sb + r0 * LDS + n) = make_float2(acc[nt][0], acc[nt][1]);
          if (!HALF)
            *reinterpret_cast<float2*>(Sb + (r0 + 8) * LDS + n) =
                make_float2(acc[nt][2], acc[nt][3]);
        } else {
          if (n < N) {
            Sb[r0 * LDS + n] = acc[nt][0];
            if (!HALF) Sb[(r0 + 8) * LDS + n] = acc[nt][2];
          }
          if (n + 1 < N) {
            Sb[r0 * LDS + n + 1] = acc[nt][1];
            if (!HALF) Sb[(r0 + 8) * LDS + n + 1] = acc[nt][3];
          }
        }
      }
    }
  }
  __syncthreads();   // S complete, the slices free
}

// VE adjacent edge values as float32: one 16-byte load, or one element.
template <int VE> __device__ __forceinline__ void load_edge(const float* p, float* o) {
  if constexpr (VE == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else {
    o[0] = __ldg(p);
  }
}
template <int VE> __device__ __forceinline__ void load_edge(const bf16* p, float* o) {
  if constexpr (VE == 8) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const bf16* e = reinterpret_cast<const bf16*>(&a);
#pragma unroll
    for (int u = 0; u < 8; ++u) o[u] = __bfloat162float(e[u]);
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}

template <class S, typename WT, typename EdgeT>
__global__ void __launch_bounds__(NTT, 1)
edge_attention_tiled_kernel(const EdgeT* __restrict__ edge,
                            const unsigned char* __restrict__ mask,
                            const WT* __restrict__ wm_e, const WT* __restrict__ we,
                            const WT* __restrict__ wk, const WT* __restrict__ wv,
                            const float* __restrict__ sp, const float* __restrict__ tp,
                            const float* __restrict__ q, VecsT<WT> v,
                            float* __restrict__ attn, float* __restrict__ edge_out,
                            unsigned char* scratch, int n, int cols, int update_edge,
                            int write_cast) {
  using L = Layout<S, WT>;
  constexpr int D = S::D, E = S::E, NH = S::NH, DH = S::DH, TJ = L::TJ, R = L::R;
  constexpr int LDX = L::LDX, LDS = L::LDS, DO = L::DO, DQ = L::DQ, EQ = L::EQ;
  // 16-byte edge loads where a row is a whole number of 16-byte pieces
  constexpr int VE = (E * (int)sizeof(EdgeT)) % 16 == 0 ? 16 / (int)sizeof(EdgeT) : 1;
  constexpr int PR = EQ / VE;                   // pieces of a staged row
  static_assert(EQ % VE == 0, "a staged row is a whole number of pieces");
  constexpr int CD = (DQ + 31) / 32, CE = (E + 31) / 32;   // values a lane of a row
  // LayerNorms in registers up to LN_REG_MAX values a lane, else over S
  constexpr bool LN_D = CD <= LN_REG_MAX, LN_E = CE <= LN_REG_MAX;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  // the block's buffers: shared memory, or (staged) its slot of the scratch
  unsigned char* buf = L::STAGED ? scratch + (size_t)blockIdx.x * L::SCRATCH_BYTES : smem;
  WT* X = reinterpret_cast<WT*>(buf + L::OFF_X);
  float* Sb = reinterpret_cast<float*>(buf + L::OFF_S);
  unsigned char* wbuf = L::STAGED ? smem : smem + L::OFF_W;
  float* O = reinterpret_cast<float*>(buf + L::OFF_O);
  float* Qs = reinterpret_cast<float*>(buf + L::OFF_Q);
  float* Ls = reinterpret_cast<float*>(buf + L::OFF_L);
  float* Mx = reinterpret_cast<float*>(buf + L::OFF_M);
  float* Sm = reinterpret_cast<float*>(buf + L::OFF_SUM);
  float* Cr = reinterpret_cast<float*>(buf + L::OFF_C);
  __shared__ long long s_base[TJ];   // element offset of edge[b, 0, j, 0]
  __shared__ int s_tok0[TJ];         // b * n, or -1 for a column past the end

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;

  // the block's TJ columns c0, c0 + 1, ... and every chunk of their sources;
  // a staged launch (at most GRID_CAP blocks) walks every gridDim-th group of
  // columns through the block's slot of the scratch
  const int c_step = L::STAGED ? gridDim.x * TJ : cols;
  for (int c0 = blockIdx.x * TJ; c0 < cols; c0 += c_step) {
    if (tid < TJ) {
      const int c = c0 + tid;
      const int b = c / n, j = c % n;
      s_base[tid] = ((long long)b * n * n + j) * E;
      s_tok0[tid] = c < cols ? b * n : -1;
    }
    for (int idx = tid; idx < TJ * D; idx += NTT) {
      const int jj = idx / D, c = idx % D;
      Qs[jj * DO + c] = c0 + jj < cols ? q[(size_t)(c0 + jj) * D + c] : 0.f;
      O[jj * DO + c] = 0.f;
    }
    for (int idx = tid; idx < TJ * NH; idx += NTT) {
      Mx[idx] = -INFINITY;
      Sm[idx] = 0.f;
    }
    __syncthreads();

    const int n_chunks = (n + TI - 1) / TI;
  #pragma unroll 1
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int i0 = ch * TI;
      const int ns = min(TI, n - i0);

      // ---- the edge chunk -> X, in the operand type; row r = source r / TJ,
      // column r % TJ; with write_cast the bf16 input edge goes out as float32
      for (int idx = tid; idx < R * PR; idx += NTT) {
        const int r = idx / PR, e0 = (idx % PR) * VE;
        const int i = i0 + r / TJ, jj = r % TJ;
        const bool ok = i < n && s_tok0[jj] >= 0 && (EQ == E || e0 < E);
        float x[VE];
        const long long off = s_base[jj] + (long long)i * n * E + e0;
        if (ok) {
          load_edge<VE>(edge + off, x);
        } else {
  #pragma unroll
          for (int u = 0; u < VE; ++u) x[u] = 0.f;
        }
  #pragma unroll
        for (int u = 0; u < VE; ++u) X[r * LDX + e0 + u] = to_op<WT>(x[u]);
        if (write_cast && ok) {
  #pragma unroll
          for (int u = 0; u < VE; ++u) edge_out[off + u] = x[u];
        }
      }
      __syncthreads();

      // ---- mem = relu(LN(edge Wm_e + node_i Wm_s + node_j Wm_t + bm)) -> X ----
      product<L, E, D>(X, wm_e, Sb, wbuf, tid);
      for (int r = wid; r < R; r += NWT) {
        const int i = i0 + r / TJ, jj = r % TJ;
        const int tok0 = s_tok0[jj];
        const bool ok = i < n && tok0 >= 0;
        float* row = Sb + r * LDS;
        if constexpr (LN_D) {
          float x[CD];
  #pragma unroll
          for (int m = 0; m < CD; ++m) {
            const int c = lane + 32 * m;
            x[m] = 0.f;
            if (c < D) {
              const float st = ok ? sp[(size_t)(tok0 + i) * D + c] + tp[(size_t)(c0 + jj) * D + c]
                                  : 0.f;
              x[m] = row[c] + st;
            }
          }
          ln_warp<D>(x, v.ln_m_g, v.ln_m_b, lane);
  #pragma unroll
          for (int m = 0; m < CD; ++m) {
            const int c = lane + 32 * m;
            if (c < DQ) X[r * LDX + c] = to_op<WT>(c < D ? fmaxf(x[m], 0.f) : 0.f);
          }
        } else {
          for (int c = lane; c < D; c += 32) {
            const float st = ok ? sp[(size_t)(tok0 + i) * D + c] + tp[(size_t)(c0 + jj) * D + c]
                                : 0.f;
            row[c] += st;
          }
          float mean, inv;
          row_stats<D>(row, lane, mean, inv);
          for (int c = lane; c < DQ; c += 32)
            X[r * LDX + c] = to_op<WT>(
                c < D ? fmaxf((row[c] - mean) * inv * to_f(v.ln_m_g[c]) + to_f(v.ln_m_b[c]), 0.f)
                      : 0.f);
        }
      }
      __syncthreads();

      // ---- edge' = LN(edge + relu(LN(mem We + be))) ----
      if (update_edge) {
        product<L, D, E>(X, we, Sb, wbuf, tid);
        for (int r = wid; r < R; r += NWT) {
          const int i = i0 + r / TJ, jj = r % TJ;
          const bool ok = i < n && s_tok0[jj] >= 0;
          const long long off = ok ? s_base[jj] + (long long)i * n * E : 0;
          float* row = Sb + r * LDS;
          if constexpr (LN_E) {
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
              if (c < E) x[m] = fmaxf(x[m], 0.f) + (ok ? to_f(edge[off + c]) : 0.f);
            }
            ln_warp<E>(x, v.ln_e2_g, v.ln_e2_b, lane);
            if (ok) {
  #pragma unroll
              for (int m = 0; m < CE; ++m) {
                const int c = lane + 32 * m;
                if (c < E) edge_out[off + c] = x[m];
              }
            }
          } else {
            for (int c = lane; c < E; c += 32) row[c] += to_f(v.be[c]);
            float mean, inv;
            row_stats<E>(row, lane, mean, inv);
            for (int c = lane; c < E; c += 32)
              row[c] = fmaxf((row[c] - mean) * inv * to_f(v.ln_e1_g[c]) + to_f(v.ln_e1_b[c]), 0.f) +
                       (ok ? to_f(edge[off + c]) : 0.f);
            row_stats<E>(row, lane, mean, inv);
            if (ok)
              for (int c = lane; c < E; c += 32)
                edge_out[off + c] = (row[c] - mean) * inv * to_f(v.ln_e2_g[c]) + to_f(v.ln_e2_b[c]);
          }
        }
        __syncthreads();   // S is read before the next product writes it
      }

      // ---- k = mem Wk; logits q[j] . k[i, j] / sqrt(dh) per head ----
      product<L, D, D>(X, wk, Sb, wbuf, tid);
      for (int idx = tid; idx < R * NH; idx += NTT) {
        const int r = idx / NH, h = idx % NH;
        const int i = i0 + r / TJ, jj = r % TJ;
        const int tok0 = s_tok0[jj];
        const float* qh = Qs + jj * DO + h * DH;
        const float* kh = Sb + r * LDS + h * DH;
        float a = 0.f;
  #pragma unroll 4
        for (int d = 0; d < DH; ++d) a = fmaf(qh[d], kh[d], a);
        const bool key_on = i < n && tok0 >= 0 && mask[tok0 + i];
        Ls[idx] = key_on ? a * S::QK_SCALE : MASKED;
      }
      __syncthreads();

      // ---- online softmax per (target, head) over the chunk's sources ----
      for (int idx = tid; idx < TJ * NH; idx += NTT) {
        const int jj = idx / NH, h = idx % NH;
        const float m_old = Mx[idx];
        float mx = m_old;
        for (int s = 0; s < ns; ++s) mx = fmaxf(mx, Ls[(s * TJ + jj) * NH + h]);
        const float corr = expf(m_old - mx);
        float sum = Sm[idx] * corr;
  #pragma unroll
        for (int s = 0; s < TI; ++s) {
          const int li = (s * TJ + jj) * NH + h;
          const float p = s < ns ? expf(Ls[li] - mx) : 0.f;
          sum += p;
          Ls[li] = p;
        }
        Mx[idx] = mx;
        Sm[idx] = sum;
        Cr[idx] = corr;
      }
      __syncthreads();

      // ---- v = mem Wv; O[j] = O[j] corr + sum_i p v ----
      product<L, D, D>(X, wv, Sb, wbuf, tid);
      for (int idx = tid; idx < TJ * D; idx += NTT) {
        const int jj = idx / D, c = idx % D, h = c / DH;
        float o = O[jj * DO + c] * Cr[jj * NH + h];
        for (int s = 0; s < ns; ++s)
          o = fmaf(Ls[(s * TJ + jj) * NH + h], Sb[(s * TJ + jj) * LDS + c], o);
        O[jj * DO + c] = o;
      }
      __syncthreads();   // X, S and the logits are free for the next chunk
    }

    // ---- attn[c] = sum_i p v / sum_i p ----
    for (int idx = tid; idx < TJ * D; idx += NTT) {
      const int jj = idx / D, c = idx % D;
      if (s_tok0[jj] >= 0)
        attn[(size_t)(c0 + jj) * D + c] = O[jj * DO + c] * (1.f / Sm[jj * NH + c / DH]);
    }
    if constexpr (L::STAGED) __syncthreads();   // the columns' state is free for the next
  }
}

// Blocks of a launch over `cols` columns: one a block of TJ, at most
// GRID_CAP where the rows are staged in scratch.
template <class L>
inline int tiled_blocks(int cols) {
  const int tiles = (cols + L::TJ - 1) / L::TJ;
  return L::STAGED && tiles > GRID_CAP ? GRID_CAP : tiles;
}

// The main kernel of the tiled layout on `s`: 0, or a CUDA error. `scratch`
// holds Layout::SCRATCH_BYTES for each of tiled_blocks(cols) blocks where the
// layout is staged (unused otherwise).
template <class S, typename WT, typename EdgeT>
int launch(const EdgeT* edge, const unsigned char* mask, const WT* wm_e, const WT* we,
           const WT* wk, const WT* wv, const float* sp, const float* tp, const float* q,
           const VecsT<WT>& v, float* attn, float* edge_out, unsigned char* scratch, int n,
           int cols, int update_edge, int write_cast, cudaStream_t s) {
  using L = Layout<S, WT>;
  if (L::STAGED && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_attention_tiled_kernel<S, WT, EdgeT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  edge_attention_tiled_kernel<S, WT, EdgeT><<<tiled_blocks<L>(cols), NTT, L::SMEM_BYTES, s>>>(
      edge, mask, wm_e, we, wk, wv, sp, tp, q, v, attn, edge_out, scratch, n, cols,
      update_edge, write_cast);
  return 0;
}

}  // namespace tiled
}  // namespace fusion
