// Fused edge-conditioned fusion-layer core for Hopper (sm_90a), bf16 operand
// mode on the tensor cores.
//
// Replaces the TPU kernel mind_tpu/ops/fusion_attention.py::_kernel (its
// pallas_call in fused_edge_attention) in the mode it runs under
// compute_dtype="bfloat16": node, weights and the first layer's edge arrive
// in bf16, every product of the pair and of the token takes bf16 operands and
// accumulates in float32, and the sums, bias adds, the three LayerNorms,
// ReLU, logits, softmax, the residual edge + eu and both outputs stay
// float32:
//
//   mem[i,j]   = relu(LN(r(edge[i,j]) Wm_e + r(node[i]) Wm_s + r(node[j]) Wm_t + bm))
//   edge'[i,j] = LN(edge[i,j] + relu(LN(r(mem[i,j]) We + be)))   (update_edge)
//   q[j] = r(node[j]) Wq + bq,  k/v[i,j] = r(mem[i,j]) Wk/Wv + bk/bv
//   out[j] = r(softmax_i(q[j].k[i,j] / sqrt(dh), masked keys -> -1e9) v) Wo + bo
//
// where r() rounds a float32 activation to bf16 as it becomes a product's
// operand, which is what the TPU's matrix unit does with it at default
// precision. The term bk_h . q_h[j] of a logit is the same for every source
// and cancels in the softmax, and the softmax weights sum to 1, so bk is never
// added and bv is added once per target (by out_proj_kernel). Node width D,
// edge width E and NH heads of dh = D / NH are compile-time constants of the
// library, and so is its layout (fusion_common.cuh): what follows is the
// resident layout (D, E multiples of 16 from 16 to 128, NH <= 16, dh a
// multiple of 8). Every other shape takes the tiled route of
// fusion_tiled.cuh (pair tiles of 128 pairs on wgmma fed by TMA); run picks
// it at compile time.
//
// Bound on the H100 (B = 8, N = 129, 128 / 128 / 8): a call with the edge
// update reads and writes B N^2 E edge values, 68.2 MB each way with a
// float32 edge (136 MB, 0.041 ms at 3.35 TB/s; 102 MB with the first
// layer's bf16 edge), against 17.65 GFLOP, 0.018 ms at 989 TFLOP/s of bf16.
// The mode is bound by bytes, so the main kernel is built to move each edge
// byte once each way and to keep copies in flight behind the products:
//
// - work: (scene, target) pairs are flattened into B N columns; a tile is 8
//   consecutive columns and all their sources, in chunks of 8 sources, so a
//   chunk is 64 (source, target) rows, source-major (row 8 s + t);
// - persistent blocks, one a multiprocessor, each walking the tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ... (a static schedule: no counter,
//   so a captured graph replays it as it is). The wave trap: a tile that had
//   to lie in one scene would give 8 x 17 = 136 tiles at B = 8, N = 129, one
//   more than the 132 multiprocessors, and four of them would take two
//   tiles, doubling the call. Tiles therefore run across scene boundaries
//   (129 tiles at B = 8: one wave);
// - a block's shared memory holds the four per-pair weights Wm_e, We, Wk,
//   Wv, loaded once by TMA into the 128B-swizzled MN-major layout that
//   wgmma reads transposed (fusion_tiled.cuh), and a ring of STAGES chunk
//   stages (2 at 128 / 128, up to 4 where narrower widths fit), each
//   signalled by an mbarrier. A chunk of a tile inside one scene arrives as
//   ceil(E / 32) (float32) or ceil(E / 64) (bf16) TMA boxes of a 4-D map over
//   [B][N][N][E] (128 bytes of E by 8 targets by 8 sources, 128B swizzle:
//   rows past N read as zero); a tile across scenes (7 of 8 scene
//   boundaries at N = 129) is gathered in 16-byte cp.async copies into the
//   same layout, from 256-byte rows by the whole group, a warp's lanes
//   reading a row's consecutive pieces, below by warp 0 (loaders(); one
//   bulk copy a row instead costs 64 copies a chunk, ~50 ns each on the
//   H100). At B = 8 every block takes one tile, so the slowest, a gathered
//   one, sets the call's time;
// - a block is two consumer warpgroups, 256 threads, so that a thread has
//   the 255 registers its accumulator (64), mem fragments (32) and softmax
//   state need. A producer warp would cost them 87 registers: warps are
//   given registers four at a time, so 288 threads are budgeted as 384
//   (168 a thread, and spills). The copies are issued by the group that
//   frees a stage instead: it refills the stage with the chunk STAGES
//   ahead the moment the stage's last bytes have been read, which is when a
//   producer waiting on an empty barrier would; the block's first chunks by
//   group 0, the weights and each tile's tp and q rows by warp 0;
// - the groups take alternate chunks of a tile (chunk ch goes to group
//   ch % 2: fixed by the column, never by the schedule), so one group's
//   epilogue runs under the other's products. Each product is
//   wgmma.mma_async.m64nNk16 (N = D or E rounded up to 64) with A in
//   registers: the edge chunk is read from its stage, rounded to bf16,
//   straight into A fragments, and mem, rounded to bf16 in the memory
//   epilogue, stays in registers as the A operand of the edge update, key
//   and value products: no operand tile is written to shared memory and no
//   barrier separates the products; the value product runs under the
//   softmax update;
// - the input chunk stays in its stage until the edge update's residual
//   has read it there; then the group hands the stage back (and refills
//   it) and finishes edge' (or, for a bf16 edge without the update,
//   its float32 cast) in registers: a quad of lanes writes a row's 8
//   columns of a group, 32 bytes, whole sectors, so each edge byte crosses
//   the bus once each way. Writing edge' back into the stage and out by TMA
//   stores would hold the stage, and the group, until the stores had read
//   it (PERF.md);
// - tp and q of a tile's 8 columns are copied once per tile, the LayerNorm
//   vectors once per block; the tp and q rows are padded and the chunk's
//   rows swizzled, so that the accumulator layout's accesses (8 rows, 4
//   lanes a row) meet no bank conflict;
// - a target's softmax is online per thread over its 2 sources a chunk; the
//   8 consumer warps' states are merged once per tile in a fixed order.
//
// Determinism: a column's rows, the split of its sources among the warps
// (chunk ch to group ch % 2, sources 2 w, 2 w + 1 of a chunk to warp w) and
// the merge order are functions of the column and N alone, never of B, the
// grid or the tile a block takes; there are no atomics. A scene computes in
// a batch what it computes alone, to the bit.

#include <mutex>

#include "fusion_common.cuh"
#include "fusion_tiled.cuh"

namespace {

using namespace fusion;
typedef __nv_bfloat16 bf16;
using tiled::smem_u32;
using tiled::mbar_init;
using tiled::mbar_arrive;
using tiled::mbar_expect_tx;
using tiled::mbar_wait;
using tiled::fence_proxy_async_smem;
using tiled::tma_load_2d;
using tiled::desc_sw128;

constexpr int TJ = 8;                           // (scene, target) columns a tile
constexpr int R = TI * TJ;                      // rows a chunk: 8 sources x 8 targets
constexpr int NTB = 256;                        // two consumer warpgroups
constexpr int W_BOX = 64 * 64 * 2;              // a weight's TMA box: 64 k rows of 64 columns
constexpr int W_KSTEP = 16 * 128;               // bytes of 16 k rows of a box
constexpr int LINE = 128;                       // bytes of a row in an edge box
constexpr int E_BOX = R * LINE;                 // an edge box: 64 rows of 128 bytes (8 KB)
constexpr int BAR_GROUP = 1, BAR_BLOCK = 3;     // named barriers (0 is __syncthreads)

__host__ __device__ constexpr int wbytes(int k, int n) {
  return (k + 63) / 64 * (round_up(n, 64) / 64) * W_BOX;
}

// The block's layout for the library's widths (bytes from a 1 KB-aligned
// base; the allocation adds 1 KB to align it).
template <class S>
struct LayoutB {
  static constexpr int D = S::D, E = S::E, NH = S::NH;
  static constexpr int ND = round_up(D, 64), NE = round_up(E, 64);   // wgmma widths
  static constexpr int OFF_WME = 0;                                  // Wm_e [E][D]
  static constexpr int OFF_WE = OFF_WME + wbytes(E, D);              // We [D][E]
  static constexpr int OFF_WK = OFF_WE + wbytes(D, E);               // Wk [D][D]
  static constexpr int OFF_WV = OFF_WK + wbytes(D, D);               // Wv [D][D]
  static constexpr int W_BYTES = OFF_WV + wbytes(D, D);
  // ln_m_g, ln_m_b (D), be, ln_e1_g, ln_e1_b, ln_e2_g, ln_e2_b (E), float32
  static constexpr int OFF_VEC = W_BYTES;
  static constexpr int VEC_BYTES = (2 * D + 5 * E) * 4;
  // a tile's tp and q rows (TROW floats apart), and after its chunks the
  // merge: the 8 warps' softmax maxima and sums, then two [TJ][D] sums
  static constexpr int TROW = D + 8;
  static constexpr int OFF_TILE = OFF_VEC + VEC_BYTES;
  static constexpr int TILE_BYTES = tiled::cmax(2 * TJ * TROW * 4, 8 * TJ * NH * 2 * 4);
  // a stage: the chunk's 64 rows in 128B-swizzled boxes of 128 bytes a row
  // (E_F32 boxes of 32 float32 columns; a bf16 edge lands in the first
  // ceil(E / 64) boxes of 64 columns), then sp of the chunk's sources in up
  // to two scenes
  static constexpr int E_F32 = (E + 31) / 32;
  static constexpr int OFF_SP = E_F32 * E_BOX;
  static constexpr int STAGE = round_up(OFF_SP + 2 * TI * D * 4, 1024);
  static constexpr int OFF_STAGE = round_up(OFF_TILE + TILE_BYTES, 1024);
  // up to 4 stages, as many as fit with their mbarriers, the tile's and
  // the weights', and 1 KB to align the base, within the card's opt-in
  // shared memory less 1 KB
  static constexpr int FIXED = OFF_STAGE + 2 * 8 + 1024, PER_STAGE = STAGE + 8;
  static constexpr int BUDGET = 232448 - 1024;
  static constexpr int STAGES = FIXED + 4 * PER_STAGE <= BUDGET   ? 4
                                : FIXED + 3 * PER_STAGE <= BUDGET ? 3
                                                                  : 2;
  static constexpr int OFF_BAR = OFF_STAGE + STAGES * STAGE;   // full[STAGES], tile, weights
  static constexpr int SMEM_BYTES = FIXED + STAGES * PER_STAGE;   // 226,336 at 128 / 128 / 8
  static constexpr int BLOCKS_PER_SM = 1;
  static_assert(FIXED + 2 * PER_STAGE <= BUDGET, "two stages must fit the H100's opt-in shared memory");
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// a bulk (TMA) copy of contiguous bytes, global -> shared, on an mbarrier's
// transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// acc (+)= a[64 x 16] w[16 x N]: a in registers (the m16n8k16 A fragment of
// the warp's 16 rows), w MN-major through a descriptor (read transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (*acc)[4], const uint32_t* a, uint64_t db,
                                         int accumulate);
#define RS_ACC4(i) "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
#define RS_WGMMA(N, REGS, A, DB, P, ...)                                                   \
  template <>                                                                            \
  __device__ __forceinline__ void wgmma_rs<N>(float (*acc)[4], const uint32_t* a,        \
                                              uint64_t db, int accumulate) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "             \
                 "{" REGS "}, {" A "}, " DB ", p, 1, 1, 1;\n}\n"                         \
                 : __VA_ARGS__                                                           \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)); \
  }
RS_WGMMA(64, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31",
         "%32, %33, %34, %35", "%36", "%37",
         RS_ACC4(0), RS_ACC4(1), RS_ACC4(2), RS_ACC4(3), RS_ACC4(4), RS_ACC4(5), RS_ACC4(6), RS_ACC4(7))
RS_WGMMA(128, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63",
         "%64, %65, %66, %67", "%68", "%69",
         RS_ACC4(0), RS_ACC4(1), RS_ACC4(2), RS_ACC4(3), RS_ACC4(4), RS_ACC4(5), RS_ACC4(6), RS_ACC4(7), RS_ACC4(8), RS_ACC4(9), RS_ACC4(10), RS_ACC4(11), RS_ACC4(12), RS_ACC4(13), RS_ACC4(14), RS_ACC4(15))
#undef RS_WGMMA
#undef RS_ACC4

template <int NG>
__device__ __forceinline__ void fence_acc(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][e])::"memory");
}

// Issue acc = a[64 x K] w[K x N] for the warpgroup and commit it (no wait):
// a as K / 16 A fragments, w a resident weight [K][N] as ceil(K / 64) slabs
// of N / 64 TMA boxes (64-column groups 8 KB apart, 8-k groups 1 KB apart).
// A thread of warp w then holds rows 16 w + lane / 4 (acc[nt][0..1]) and
// + 8 (acc[nt][2..3]), columns 8 nt + 2 (lane % 4) + {0, 1}.
template <int N, int K, int NG>
__device__ __forceinline__ void issue_product(const uint32_t (*a)[4], const unsigned char* w,
                                              float (*acc)[4]) {
  static_assert(N == 64 || N == 128, "a product 64 or 128 wide");
  constexpr int SLAB = (N / 64) * W_BOX;
  const uint32_t base = smem_u32(w);
  fence_acc<NG>(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_rs<N>(acc, a[ks],
                desc_sw128(base + (ks >> 2) * SLAB + (ks & 3) * W_KSTEP, tiled::W_LBO,
                           tiled::W_SBO),
                ks > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until the warpgroup's products, such as the one that writes acc,
// are complete.
template <int NG>
__device__ __forceinline__ void wait_product(float (*acc)[4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc<NG>(acc);
}

// Two-pass LayerNorm, in place, of the thread's two W-wide rows as the
// accumulator holds them: row 0 in x[nt][0..1], row 1 in x[nt][2..3]
// (nt < W / 8), each row spread over the 4 lanes of a quad. The two rows'
// sums go through their shuffles side by side. gamma and beta float32 in
// shared memory.
template <int W>
__device__ __forceinline__ void ln_rows(float (*x)[4], const float* g, const float* b,
                                        int q2) {
  // four partial sums a row (groups nt % 4), added in a fixed order: short
  // dependency chains for the two warps a scheduler holds
  constexpr int P = W / 8 >= 4 ? 4 : W / 8;
  float s0[P], s1[P], sq0[P], sq1[P];
#pragma unroll
  for (int u = 0; u < P; ++u) s0[u] = s1[u] = sq0[u] = sq1[u] = 0.f;
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) {
    s0[nt % P] += x[nt][0] + x[nt][1];
    s1[nt % P] += x[nt][2] + x[nt][3];
  }
#pragma unroll
  for (int u = 1; u < P; ++u) {
    s0[0] += s0[u];
    s1[0] += s1[u];
  }
  const float mean0 = quad_sum(s0[0]) * (1.f / W), mean1 = quad_sum(s1[0]) * (1.f / W);
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) {
    const float d0 = x[nt][0] - mean0, d1 = x[nt][1] - mean0;
    const float d2 = x[nt][2] - mean1, d3 = x[nt][3] - mean1;
    sq0[nt % P] = fmaf(d1, d1, fmaf(d0, d0, sq0[nt % P]));
    sq1[nt % P] = fmaf(d3, d3, fmaf(d2, d2, sq1[nt % P]));
  }
#pragma unroll
  for (int u = 1; u < P; ++u) {
    sq0[0] += sq0[u];
    sq1[0] += sq1[u];
  }
  const float inv0 = rsqrtf(quad_sum(sq0[0]) * (1.f / W) + LN_EPS);
  const float inv1 = rsqrtf(quad_sum(sq1[0]) * (1.f / W) + LN_EPS);
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) {
    const float2 gv = *reinterpret_cast<const float2*>(g + nt * 8 + q2);
    const float2 bv = *reinterpret_cast<const float2*>(b + nt * 8 + q2);
    x[nt][0] = (x[nt][0] - mean0) * inv0 * gv.x + bv.x;
    x[nt][1] = (x[nt][1] - mean0) * inv0 * gv.y + bv.y;
    x[nt][2] = (x[nt][2] - mean1) * inv1 * gv.x + bv.x;
    x[nt][3] = (x[nt][3] - mean1) * inv1 * gv.y + bv.y;
  }
}

// Element (row r, column c) of a chunk in a stage: 128B-swizzled boxes of
// 128 bytes a row (the TMA layout: 16-byte piece p of row r at piece
// p ^ (r % 8)), so that the accumulator layout's accesses (8 rows, 4 lanes
// a row) fall in 8 different pieces of the 32 banks.
template <typename T>
__device__ __forceinline__ T* stage_at(unsigned char* stage, int r, int c) {
  constexpr int PER_LINE = LINE / sizeof(T), PER_PIECE = 16 / sizeof(T);
  const int k = c / PER_LINE, cc = c % PER_LINE;
  return reinterpret_cast<T*>(stage + k * E_BOX + r * LINE +
                              (((cc / PER_PIECE) ^ (r & 7)) << 4) +
                              (cc % PER_PIECE) * (int)sizeof(T));
}
// the same for 16-byte piece p of row r
__device__ __forceinline__ unsigned char* stage_piece(unsigned char* stage, int r, int p) {
  return stage + (p >> 3) * E_BOX + r * LINE + (((p & 7) ^ (r & 7)) << 4);
}

// Two adjacent edge values of a stage row: float32, or bf16 widened; and
// as a bf16 A fragment register.
__device__ __forceinline__ float2 edge_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 edge_pair(const bf16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ uint32_t edge_frag(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t edge_frag(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// TMA of an edge box: 128 bytes of E by 8 targets by 8 sources of one scene
// (a 4-D map over [B][N][N][E]); rows out of range read as zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int x, int y,
                                            int z, int w, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z), "r"(w)
      : "memory");
}
// The thread's arrival on `bar` once its cp.async copies so far have landed
// (the arrival counts against the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

#ifdef FUSION_TRACE
// Built with -DFUSION_TRACE (tools/check_fusion_kernels.py --trace): the
// cycles each consumer group's first thread spends from one mark to the
// next (steps 1-10 of the main loop), summed over the blocks, in [0] its
// whole loop, and in [11] the longest whole loop of a block.
__device__ unsigned long long g_trace[2][12];
#define TRACE_START() long long tr_last = clock64(), tr_first = tr_last
#define TRACE_MARK(k)                                                                    \
  do {                                                                                   \
    if (tid % 128 == 0) {                                                                \
      const long long now = clock64();                                                   \
      atomicAdd(&g_trace[cw][k], (unsigned long long)(now - tr_last));                   \
      tr_last = now;                                                                     \
    }                                                                                    \
  } while (0)
#define TRACE_END()                                                                      \
  do {                                                                                   \
    if (tid % 128 == 0) {                                                                \
      const unsigned long long whole = clock64() - tr_first;                             \
      atomicAdd(&g_trace[cw][0], whole);                                                 \
      atomicMax(&g_trace[cw][11], whole);                                                \
    }                                                                                    \
  } while (0)
#else
#define TRACE_START()
#define TRACE_MARK(k)
#define TRACE_END()
#endif

// The threads of a consumer group that load a chunk, and so arrive on its
// stage's full barrier: the whole group where an edge row is 256 bytes or
// more (float32 from E = 64, bf16 at 128), so that a gathered row is read by
// a warp's lanes at once; warp 0 alone below, where a gathered chunk is 64
// short rows and the group's 128 arrivals, not the copies, would hold it
// (PERF.md §6).
template <class S, typename EdgeT>
__host__ __device__ constexpr int loaders() {
  return S::E * (int)sizeof(EdgeT) >= 256 ? 128 : 32;
}

// Load chunk t of the block's sequence (tile t / nch of the block, chunk
// t % nch of it) into stage t % STAGES, by the loaders() threads of a
// consumer group (gtid its thread); nothing past the block's last tile. A
// tile inside one scene takes a TMA box a 128 bytes of E (8 targets x 8
// sources), issued by warp 0; a tile across scenes is gathered in 16-byte
// copies into the same swizzled layout (rows past N or past the last column
// zero): by the group, warp w taking rows w, w + 4, ..., its lanes a row's
// consecutive pieces, so that a copy instruction reads whole rows; by warp
// 0, lane l taking rows l and l + 32. The chunk's sp rows follow by bulk
// copies where N >= 8. Each loader then arrives on the stage's full
// barrier: the gathering ones once their copies have landed.
template <class S, typename EdgeT>
__device__ __forceinline__ void load_chunk(const CUtensorMap* map_edge, const EdgeT* edge,
                                           const float* sp, unsigned char* smem,
                                           uint64_t* full, int t, int n, int cols, int ntiles,
                                           int nch, int gtid) {
  using L = LayoutB<S>;
  constexpr int D = S::D, E = S::E, ES = sizeof(EdgeT);
  constexpr int PER_LINE = LINE / ES, NBOX = (E + PER_LINE - 1) / PER_LINE, PPR = E * ES / 16;
  const int kl = t / nch, ch = t - kl * nch;
  const int tile = blockIdx.x + kl * gridDim.x;
  if (tile >= ntiles) return;
  const int s = t % L::STAGES;
  unsigned char* stage = smem + L::OFF_STAGE + s * L::STAGE;
  const int c0 = tile * TJ, b0 = c0 / n, b_last = (min(c0 + TJ, cols) - 1) / n;
  const int i0 = ch * TI, rows_sp = min(TI, n - i0);
  const bool boxed = b_last == b0;
  const int scenes = n >= TI ? 1 + (b_last > b0) : 0;
  if (gtid < 32) {
    if (gtid == 0)
      mbar_expect_tx(&full[s], (boxed ? NBOX * E_BOX : 0) + scenes * rows_sp * D * 4);
    __syncwarp();
    if (boxed && gtid < NBOX)
      tma_load_4d(stage + gtid * E_BOX, map_edge, gtid * PER_LINE, c0 - b0 * n, i0, b0, &full[s]);
    if (gtid < scenes)
      bulk_load(stage + L::OFF_SP + gtid * TI * D * 4, sp + ((size_t)(b0 + gtid) * n + i0) * D,
                rows_sp * D * 4, &full[s]);
  }
  if (boxed) {
    mbar_arrive(&full[s]);
    return;
  }
  // row r: target r % 8 of the tile (scene b: at most two from N = 8),
  // source i0 + r / 8; its pieces p0, p0 + step, ... below PPR
  auto gather_row = [&](int r, int p0, int step) {
    const int c = c0 + (r & 7), i = i0 + (r >> 3);
    const int b = n >= TI ? b0 + (c >= (b0 + 1) * n) : (int)((unsigned)c / (unsigned)n);
    const bool ok = c < cols && i < n;
    const EdgeT* src = ok ? edge + (((long long)b * n + i) * n + (c - b * n)) * E : edge;
#pragma unroll 4
    for (int p = p0; p < PPR; p += step)
      cp_async16(stage_piece(stage, r, p), ok ? src + p * (16 / ES) : edge, ok);
  };
  const int lane = gtid & 31;
  if constexpr (loaders<S, EdgeT>() == 128) {
#pragma unroll 4
    for (int r = gtid >> 5; r < R; r += 4) gather_row(r, lane, 32);
  } else {
#pragma unroll
    for (int r = lane; r < R; r += 32) gather_row(r, 0, 1);
  }
  cp_async_arrive(&full[s]);
}

// A tile's tp and q rows into the tile region (padded rows), by one warp.
template <class S>
__device__ __forceinline__ void load_tile(const float* tp, const float* q, float* tile_tp,
                                          uint64_t* bar, int tile, int cols, int lane) {
  constexpr int D = S::D, TROW = LayoutB<S>::TROW;
  const int c0 = tile * TJ, ncols = min(TJ, cols - c0), jj = lane & 7;
  if (lane == 0) mbar_expect_tx(bar, 2 * ncols * D * 4);
  __syncwarp();
  if (lane < 2 * TJ && jj < ncols)
    bulk_load(tile_tp + (lane < TJ ? 0 : TJ * TROW) + jj * TROW,
              (lane < TJ ? tp : q) + (size_t)(c0 + jj) * D, D * 4, bar);
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <class S, typename EdgeT>
__global__ void __launch_bounds__(NTB, 1)
edge_attention_bf16_persistent(const __grid_constant__ CUtensorMap map_wme,
                               const __grid_constant__ CUtensorMap map_we,
                               const __grid_constant__ CUtensorMap map_wk,
                               const __grid_constant__ CUtensorMap map_wv,
                               const __grid_constant__ CUtensorMap map_edge,
                               const EdgeT* __restrict__ edge,
                               const unsigned char* __restrict__ mask,
                               const float* __restrict__ sp, const float* __restrict__ tp,
                               const float* __restrict__ q, VecsT<bf16> v,
                               float* __restrict__ attn, float* __restrict__ edge_out,
                               int n, int cols, int update_edge, int write_cast) {
  using L = LayoutB<S>;
  constexpr int D = S::D, E = S::E, NH = S::NH, DH = S::DH, ST = L::STAGES;
  constexpr int ND = L::ND, NE = L::NE, NG = (ND > NE ? ND : NE) / 8;
  constexpr int GD = D / 8, GE = E / 8;            // 8-column groups of a D- and an E-wide row
  constexpr int LOADERS = loaders<S, EdgeT>();
  extern __shared__ float4 smem4[];
  // 1 KB aligned by an offset from the shared array itself, so that the
  // compiler keeps every access below a shared-memory one
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4) +
                        ((1024u - (smem_u32(smem4) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* tile_full = full + ST;
  uint64_t* weights_full = tile_full + 1;
  float* vec = reinterpret_cast<float*>(smem + L::OFF_VEC);
  float* tile_tp = reinterpret_cast<float*>(smem + L::OFF_TILE);   // [TJ][TROW]
  float* tile_q = tile_tp + TJ * L::TROW;                           // [TJ][TROW]

  // group cw (warps 4 cw .. 4 cw + 3), its warp `warp`; w8 the block's warp
  const int tid = threadIdx.x, lane = tid & 31, cw = tid >> 7, warp = (tid >> 5) & 3,
            w8 = tid >> 5;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int ntiles = (cols + TJ - 1) / TJ, nch = (n + TI - 1) / TI;
  // sp rows are staged with their chunk where a tile touches at most two
  // scenes (N >= 8); below 8 nodes they are read from memory
  const bool sp_staged = n >= TI;
  const bool stores = update_edge || write_cast;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], LOADERS);
    mbar_init(tile_full, 1);
    mbar_init(weights_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (w8 == 0) {
    // the block's first copies: the weights and its first tile's rows by
    // warp 0, the first STAGES chunks by group 0's loaders; later chunks are
    // loaded by the group that frees their stage, a tile's rows after the
    // previous tile's merge
    if (lane == 0) {
      mbar_expect_tx(weights_full, L::W_BYTES);
      auto load_w = [&](const CUtensorMap* map, int off, int k, int nn) {
        for (int kk = 0; kk < (k + 63) / 64; ++kk)
          for (int x = 0; x < round_up(nn, 64) / 64; ++x)
            tma_load_2d(smem + off + (kk * (round_up(nn, 64) / 64) + x) * W_BOX, map, x * 64,
                        kk * 64, weights_full);
      };
      load_w(&map_wme, L::OFF_WME, E, D);
      load_w(&map_we, L::OFF_WE, D, E);
      load_w(&map_wk, L::OFF_WK, D, D);
      load_w(&map_wv, L::OFF_WV, D, D);
      mbar_arrive(weights_full);
    }
    load_tile<S>(tp, q, tile_tp, tile_full, blockIdx.x, cols, lane);
  }
  if (tid < LOADERS)
    for (int t = 0; t < ST; ++t)
      load_chunk<S, EdgeT>(&map_edge, edge, sp, smem, full, t, n, cols, ntiles, nch, tid);
  // the LayerNorm vectors, float32, once per block
  {
    const bf16* src[7] = {v.ln_m_g, v.ln_m_b, v.be, v.ln_e1_g, v.ln_e1_b, v.ln_e2_g, v.ln_e2_b};
    for (int k = tid; k < 2 * D + 5 * E; k += NTB) {
      const int which = k < 2 * D ? k / D : 2 + (k - 2 * D) / E;
      const int x = k < 2 * D ? k % D : (k - 2 * D) % E;
      vec[k] = __bfloat162float(src[which][x]);
    }
  }
  const float *ln_m_g = vec, *ln_m_b = vec + D, *be = vec + 2 * D, *ln_e1_g = be + E,
              *ln_e1_b = be + 2 * E, *ln_e2_g = be + 3 * E, *ln_e2_b = be + 4 * E;
  __syncthreads();
  mbar_wait(weights_full, 0);
  TRACE_START();

  float acc[NG][4];
  uint32_t mf[D / 16][4];   // mem as the A fragments of the edge update, key and value products
  int t_base = 0;
  for (int tile = blockIdx.x, kl = 0; tile < ntiles; tile += gridDim.x, ++kl, t_base += nch) {
    const int c0 = tile * TJ, b0 = c0 / n;
    // the thread's target: column g of the tile, in scene col_b
    const bool col_ok = c0 + g < cols;
    const int col_b = (c0 + g) / n;
    const int tok0 = col_ok ? col_b * n : 0, slot = col_ok ? col_b - b0 : 0;
    float run_m[NH], run_s[NH], o[GD][2];
#pragma unroll
    for (int h = 0; h < NH; ++h) { run_m[h] = -INFINITY; run_s[h] = 0.f; }
#pragma unroll
    for (int nt = 0; nt < GD; ++nt) o[nt][0] = o[nt][1] = 0.f;
    bool tile_ready = false;

    for (int ch = cw; ch < nch; ch += 2) {
      const int t = t_base + ch, s = t % ST, i0 = ch * TI;
      unsigned char* stage = smem + L::OFF_STAGE + s * L::STAGE;
      // the thread's rows: 16 warp + g (source 2 warp) and + 8 (source 2 warp + 1)
      const int r0 = 16 * warp + g;
      bool key_on[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 2 * warp + hh;
        key_on[hh] = col_ok && i < n && mask[tok0 + i];
      }
      mbar_wait(&full[s], (t / ST) & 1);
      TRACE_MARK(1);    // waiting for the chunk

      // ---- mem = relu(LN(edge Wm_e + node_i Wm_s + node_j Wm_t + bm)) ----
      {
        uint32_t ef[E / 16][4];
#pragma unroll
        for (int ks = 0; ks < E / 16; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            ef[ks][r] = edge_frag(stage_at<EdgeT>(stage, r0 + 8 * (r & 1), 16 * ks + 8 * (r >> 1) + q2));
        issue_product<ND, E, NG>(ef, smem + L::OFF_WME, acc);
        wait_product<NG>(acc);
      }
      TRACE_MARK(2);    // edge fragments and memory product
      if (!tile_ready) {
        mbar_wait(tile_full, kl & 1);
        tile_ready = true;
      }
      {
        const float* tpr = tile_tp + g * L::TROW;
        // + sp of the two sources (staged rows, or memory below 8 nodes) + tp
        auto add_sp_tp = [&](const float* sp0, const float* sp1) {
#pragma unroll
          for (int nt = 0; nt < GD; ++nt) {
            const float2 b = *reinterpret_cast<const float2*>(tpr + nt * 8 + q2);
            const float2 a0 = *reinterpret_cast<const float2*>(sp0 + nt * 8 + q2);
            const float2 a1 = *reinterpret_cast<const float2*>(sp1 + nt * 8 + q2);
            acc[nt][0] = acc[nt][0] + a0.x + b.x;
            acc[nt][1] = acc[nt][1] + a0.y + b.y;
            acc[nt][2] = acc[nt][2] + a1.x + b.x;
            acc[nt][3] = acc[nt][3] + a1.y + b.y;
          }
        };
        if (sp_staged) {
          const float* spr = reinterpret_cast<const float*>(stage + L::OFF_SP) +
                             (slot * TI + 2 * warp) * D;
          add_sp_tp(spr, spr + D);
        } else {
          add_sp_tp(sp + (size_t)(tok0 + min(i0 + 2 * warp, n - 1)) * D,
                    sp + (size_t)(tok0 + min(i0 + 2 * warp + 1, n - 1)) * D);
        }
        ln_rows<D>(acc, ln_m_g, ln_m_b, q2);
#pragma unroll
        for (int nt = 0; nt < GD; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            mf[nt >> 1][(nt & 1) * 2 + hh] =
                pack_bf16(fmaxf(acc[nt][hh * 2], 0.f), fmaxf(acc[nt][hh * 2 + 1], 0.f));
      }

      // ---- edge' = LN(edge + relu(LN(mem We + be))), or the bf16 edge cast ----
      TRACE_MARK(3);    // tile rows and memory epilogue
      if (update_edge) {
        issue_product<NE, D, NG>(mf, smem + L::OFF_WE, acc);
        wait_product<NG>(acc);
#pragma unroll
        for (int nt = 0; nt < GE; ++nt) {
          const float2 bv = *reinterpret_cast<const float2*>(be + nt * 8 + q2);
          acc[nt][0] += bv.x;
          acc[nt][1] += bv.y;
          acc[nt][2] += bv.x;
          acc[nt][3] += bv.y;
        }
        ln_rows<E>(acc, ln_e1_g, ln_e1_b, q2);
      }
      if (stores) {
        // relu(LN(mem We + be)) + the residual, read from the stage (or the
        // residual alone: the cast)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int nt = 0; nt < GE; ++nt) {
            const float2 e = edge_pair(stage_at<EdgeT>(stage, r0 + 8 * hh, nt * 8 + q2));
            acc[nt][hh * 2] = update_edge ? fmaxf(acc[nt][hh * 2], 0.f) + e.x : e.x;
            acc[nt][hh * 2 + 1] = update_edge ? fmaxf(acc[nt][hh * 2 + 1], 0.f) + e.y : e.y;
          }
      }
      TRACE_MARK(4);    // edge update product, first LayerNorm, residual
      // the group has read the stage: it refills it with chunk t + STAGES
      named_barrier(BAR_GROUP + cw, 128);
      if ((tid & 127) < LOADERS)
        load_chunk<S, EdgeT>(&map_edge, edge, sp, smem, full, t + ST, n, cols, ntiles, nch,
                             tid & 127);
      if (stores) {
        if (update_edge) ln_rows<E>(acc, ln_e2_g, ln_e2_b, q2);
        // edge' from the accumulator layout: a quad's 4 lanes write a row's
        // 8 columns of a group, 32 bytes, whole sectors
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = i0 + 2 * warp + hh;
          if (col_ok && i < n) {
            float* dst = edge_out + (((long long)col_b * n + i) * n + (c0 + g - col_b * n)) * E;
#pragma unroll
            for (int nt = 0; nt < GE; ++nt)
              *reinterpret_cast<float2*>(dst + nt * 8 + q2) =
                  make_float2(acc[nt][hh * 2], acc[nt][hh * 2 + 1]);
          }
        }
      }
      TRACE_MARK(5);    // stage release, second LayerNorm, edge stores

      // ---- k = mem Wk; logits q[j] . k[i,j] / sqrt(dh) per head ----
      float (*kacc)[4] = acc;
      issue_product<ND, D, NG>(mf, smem + L::OFF_WK, kacc);
      wait_product<NG>(kacc);
      TRACE_MARK(6);    // key product
      float lg[2][NH];
      {
        float part[2][NH];
#pragma unroll
        for (int h = 0; h < NH; ++h) part[0][h] = part[1][h] = 0.f;
        const float* qr = tile_q + g * L::TROW;
#pragma unroll
        for (int nt = 0; nt < GD; ++nt) {
          const float2 qv = *reinterpret_cast<const float2*>(qr + nt * 8 + q2);
          // an 8-column group lies in one head: dh is a multiple of 8
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            part[hh][nt * 8 / DH] += kacc[nt][hh * 2] * qv.x + kacc[nt][hh * 2 + 1] * qv.y;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            const float sc = quad_sum(part[hh][h]) * S::QK_SCALE;
            lg[hh][h] = key_on[hh] ? sc : MASKED;
          }
      }

      // ---- v = mem Wv, under the softmax update of the two sources ----
      TRACE_MARK(7);    // logits
      issue_product<ND, D, NG>(mf, smem + L::OFF_WV, kacc);
      const bool on0 = i0 + 2 * warp < n, on1 = i0 + 2 * warp + 1 < n;   // uniform over the warp
      if (on0) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float m_new = on1 ? fmaxf(run_m[h], fmaxf(lg[0][h], lg[1][h]))
                                  : fmaxf(run_m[h], lg[0][h]);
          const float corr = expf(run_m[h] - m_new);
          lg[0][h] = expf(lg[0][h] - m_new);
          lg[1][h] = on1 ? expf(lg[1][h] - m_new) : 0.f;
          run_s[h] = run_s[h] * corr + lg[0][h] + lg[1][h];
          run_m[h] = m_new;
#pragma unroll
          for (int u = 0; u < DH / 8; ++u) {
            o[(DH / 8) * h + u][0] *= corr;
            o[(DH / 8) * h + u][1] *= corr;
          }
        }
      }
      wait_product<NG>(kacc);
      TRACE_MARK(8);    // value product and softmax update
      if (on0) {
#pragma unroll
        for (int nt = 0; nt < GD; ++nt) {
          const int h = nt * 8 / DH;
          o[nt][0] = fmaf(lg[1][h], kacc[nt][2], fmaf(lg[0][h], kacc[nt][0], o[nt][0]));
          o[nt][1] = fmaf(lg[1][h], kacc[nt][3], fmaf(lg[0][h], kacc[nt][1], o[nt][1]));
        }
      }
      TRACE_MARK(9);    // weighted values
    }

    // ---- merge the 8 warps' softmax states; attn[c] = sum_i p v / sum_i p ----
    named_barrier(BAR_BLOCK, NTB);   // the tile's chunks are done: its region is free
    float* mrg_m = tile_tp;          // [8 warps][TJ][NH]
    float* mrg_s = tile_tp + 8 * TJ * NH;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        mrg_m[(w8 * TJ + g) * NH + h] = run_m[h];
        mrg_s[(w8 * TJ + g) * NH + h] = run_s[h];
      }
    }
    named_barrier(BAR_BLOCK, NTB);
    // o / sum of the column's weights, each warp's state rescaled to the
    // column's largest logit
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int x = 0; x < 8; ++x) mx = fmaxf(mx, mrg_m[(x * TJ + g) * NH + h]);
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x)
        sum = fmaf(mrg_s[(x * TJ + g) * NH + h], expf(mrg_m[(x * TJ + g) * NH + h] - mx), sum);
      const float f = expf(run_m[h] - mx) / sum;
#pragma unroll
      for (int u = 0; u < DH / 8; ++u) {
        o[(DH / 8) * h + u][0] *= f;
        o[(DH / 8) * h + u][1] *= f;
      }
    }
    named_barrier(BAR_BLOCK, NTB);   // maxima and sums read: the region takes the sums
    // warps 0, 2, 4, 6 summed in that order into one [TJ][D] buffer, warps
    // 1, 3, 5, 7 into the other
    float* acc_o = tile_tp + (w8 & 1) * TJ * D + g * D;
#pragma unroll 1
    for (int round = 0; round < 4; ++round) {
      if ((w8 >> 1) == round) {
#pragma unroll
        for (int nt = 0; nt < GD; ++nt) {
          float2* p = reinterpret_cast<float2*>(acc_o + nt * 8 + q2);
          if (round == 0) *p = make_float2(o[nt][0], o[nt][1]);
          else *p = make_float2(p->x + o[nt][0], p->y + o[nt][1]);
        }
      }
      named_barrier(BAR_BLOCK, NTB);
    }
    for (int k = tid; k < TJ * D / 4; k += NTB) {
      const int jj = k / (D / 4), c4 = (k % (D / 4)) * 4;
      if (c0 + jj < cols) {
        const float4 a = *reinterpret_cast<const float4*>(tile_tp + jj * D + c4);
        const float4 b = *reinterpret_cast<const float4*>(tile_tp + TJ * D + jj * D + c4);
        *reinterpret_cast<float4*>(attn + (size_t)(c0 + jj) * D + c4) =
            make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      }
    }
    fence_proxy_async_smem();        // the next tile's rows land here by bulk copies
    named_barrier(BAR_BLOCK, NTB);
    TRACE_MARK(10);   // merge
    if (w8 == 0 && tile + gridDim.x < ntiles)
      load_tile<S>(tp, q, tile_tp, tile_full, tile + gridDim.x, cols, lane);
  }
  TRACE_END();
}

// The SMs of the current device (cached per device), for the persistent grid.
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// A 4-D map of an edge tensor [B][N][N][E] of float32 or bf16 values:
// boxes of 128 bytes of E by 8 targets by 8 sources of one scene, 128B
// swizzle; what lies out of range reads as zero.
inline int make_edge_map(CUtensorMap* map, const void* base, bool bf, int e, int n, int b) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tiled::encode_fn();
  if (fn == nullptr) return tiled::ERR_TMA;
  const cuuint64_t es = bf ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)e, (cuuint64_t)n, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[3] = {e * es, (cuuint64_t)n * e * es, (cuuint64_t)n * n * e * es};
  const cuuint32_t box[4] = {(cuuint32_t)(LINE / es), TJ, TI, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : tiled::ERR_TMA;
}

// Encoded tensor maps, kept by what they encode (base address, shape,
// element type): encoding five maps takes more host time than a narrow
// call's kernels. A map holds no data, so one made for a freed tensor serves
// a new one at the same address and shape.
struct MapCache {
  static constexpr int SIZE = 64;
  struct Entry {
    uint64_t key[5];
    CUtensorMap map;
  };
  Entry entries[SIZE];
  int used = 0, next = 0;
  std::mutex mutex;
};

// The map `encode` makes for `key` ({base, kind, then its widths}), from
// the cache or encoded now and kept.
template <class F>
int cached_map(CUtensorMap* map, const uint64_t (&key)[5], F encode) {
  static MapCache cache;
  std::lock_guard<std::mutex> lock(cache.mutex);
  for (int k = 0; k < cache.used; ++k) {
    if (memcmp(cache.entries[k].key, key, sizeof(key)) == 0) {
      *map = cache.entries[k].map;
      return 0;
    }
  }
  const int err = encode(map);
  if (err != 0) return err;
  MapCache::Entry& slot = cache.entries[cache.next];
  memcpy(slot.key, key, sizeof(key));
  slot.map = *map;
  cache.next = (cache.next + 1) % MapCache::SIZE;
  if (cache.used < MapCache::SIZE) ++cache.used;
  return 0;
}

// A resident weight [K][N] in 64 x 64 boxes (tiled::make_map).
inline int weight_map(CUtensorMap* map, const void* w, int k, int n) {
  const uint64_t key[5] = {(uint64_t)w, 0, (uint64_t)k, (uint64_t)n, 0};
  return cached_map(map, key, [&](CUtensorMap* m) {
    return tiled::make_map(m, w, n, k, (uint64_t)n * 2, 64, 64);
  });
}

template <class S, typename EdgeT>
int launch_main(const void* edge, const unsigned char* mask, const bf16* wm_e,
                const bf16* we, const bf16* wk, const bf16* wv, const float* sp,
                const float* tp, const float* q, const VecsT<bf16>& v, float* attn,
                float* edge_out, unsigned char* scratch, int n, int cols, int update_edge,
                int write_cast, cudaStream_t s) {
  if constexpr (S::RESIDENT) {
    using L = LayoutB<S>;
    constexpr int D = S::D, E = S::E;
    constexpr bool BF = sizeof(EdgeT) == 2;
    CUtensorMap m_wme, m_we, m_wk, m_wv, m_edge;
    int err = weight_map(&m_wme, wm_e, E, D);
    if (err == 0) err = weight_map(&m_we, we, D, E);
    if (err == 0) err = weight_map(&m_wk, wk, D, D);
    if (err == 0) err = weight_map(&m_wv, wv, D, D);
    const uint64_t key[5] = {(uint64_t)edge, BF ? 2u : 1u, (uint64_t)E, (uint64_t)n,
                             (uint64_t)(cols / n)};
    if (err == 0)
      err = cached_map(&m_edge, key, [&](CUtensorMap* m) {
        return make_edge_map(m, edge, BF, E, n, cols / n);
      });
    if (err != 0) return err;
    auto fn = edge_attention_bf16_persistent<S, EdgeT>;
    const cudaError_t cerr =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
    if (cerr != cudaSuccess) return (int)cerr;
    const int tiles = (cols + TJ - 1) / TJ;
    const int grid = min(tiles, sm_count() * L::BLOCKS_PER_SM);
    fn<<<grid, NTB, L::SMEM_BYTES, s>>>(m_wme, m_we, m_wk, m_wv, m_edge,
                                        static_cast<const EdgeT*>(edge), mask, sp, tp, q, v, attn,
                                        edge_out, n, cols, update_edge, write_cast);
    return 0;
  } else {
    return tiled::run_pairs<S, bf16, EdgeT>(static_cast<const EdgeT*>(edge), mask, wm_e, we, wk,
                                            wv, sp, tp, q, v, attn, edge_out, scratch, cols / n, n,
                                            update_edge, write_cast, s);
  }
}

// The main kernel's shared memory at the widths S, in its layout.
template <class S>
constexpr int smem_bytes() {
  if constexpr (S::RESIDENT) return (int)LayoutB<S>::SMEM_BYTES;
  else return tiled::Layout<S, bf16>::SMEM_BYTES;
}

struct Call {
  const void *node, *edge;
  int node_bf16, edge_bf16;
  const unsigned char* mask;
  const bf16 *wm_e, *wm_s, *wm_t, *wq, *wk, *wv, *wo, *we;
  float *sp, *tp, *q, *attn, *out, *edge_out;
  unsigned char* scratch;
  int batch, n, update_edge, write_cast;
  cudaStream_t stream;
};

// prologue + main + epilogue, at the widths S in their layout
template <class S>
int run(const Call& c, const VecsT<bf16>& v) {
  if (smem_bytes<S>() > smem_optin()) return ERR_SMEM;
  const int cols = c.batch * c.n;
  constexpr int TR = TOK, CBZ = token_col_blocks<S>();
  const dim3 tok_grid((cols + TR - 1) / TR, 3, CBZ);
  cudaStream_t s = c.stream;
  // the per-token products in float32 FMAs over bf16-rounded operands, in
  // both layouts (fusion_tiled.cuh says why not on the tensor cores)
  if (c.node_bf16)
    token_proj_kernel<S, bf16, bf16, false><<<tok_grid, NT, 0, s>>>(
        (const bf16*)c.node, c.wm_s, c.wm_t, c.wq, c.wk, v, c.sp, c.tp, c.q, cols);
  else
    token_proj_kernel<S, float, bf16, false><<<tok_grid, NT, 0, s>>>(
        (const float*)c.node, c.wm_s, c.wm_t, c.wq, c.wk, v, c.sp, c.tp, c.q, cols);
  const int err =
      c.edge_bf16 ? launch_main<S, bf16>(c.edge, c.mask, c.wm_e, c.we, c.wk, c.wv, c.sp, c.tp,
                                         c.q, v, c.attn, c.edge_out, c.scratch, c.n, cols,
                                         c.update_edge, c.write_cast, s)
                  : launch_main<S, float>(c.edge, c.mask, c.wm_e, c.we, c.wk, c.wv, c.sp,
                                          c.tp, c.q, v, c.attn, c.edge_out, c.scratch, c.n,
                                          cols, c.update_edge, c.write_cast, s);
  if (err != 0) return err;
  constexpr int TK = out_tokens<S, false>();
  out_proj_kernel<S, bf16, false><<<dim3((cols + TK - 1) / TK, 1, CBZ), NT, 0, s>>>(
      c.attn, c.wv, c.wo, v, c.out, cols);
  return (int)cudaGetLastError();
}

// {the largest dynamic shared memory of a kernel, 0 resident / 1 tiled,
// columns a block (resident; 0 tiled), fold (0), tile rows, tile columns,
// stages, epilogue LayerNorms (1 memory, 2 edge), scratch bytes a pair (S,
// M, L)}: 11 values, as fusion_attention.cu's; then blocks a multiprocessor
// of the persistent resident kernel (0 tiled). Resident: rows a chunk,
// columns a tile and the ring's stages in the tile's three places.
template <class S>
void layout_of(int* out) {
  if constexpr (S::RESIDENT) {
    using L = LayoutB<S>;
    const int v[12] = {smem_bytes<S>(), 0, TJ, 0, R, TJ, L::STAGES, 0, 0, 0, 0, L::BLOCKS_PER_SM};
    for (int k = 0; k < 12; ++k) out[k] = v[k];
  } else {
    using L = tiled::Layout<S, bf16>;
    const int v[12] = {L::SMEM_BYTES, 1, 0, 0, tiled::BM, L::BN, L::STAGES,
                       (L::EPI_MEM_LN ? 1 : 0) | (L::EPI_EDGE_LN ? 2 : 0), L::PAIR_S, L::PAIR_M,
                       L::PAIR_L, 0};
    for (int k = 0; k < 12; ++k) out[k] = v[k];
  }
}

// The library's kernels in fusion_attention.py::kernel_names' order; their
// count.
template <class S>
int kernels_of(const void** fns) {
  int k = 0;
  fns[k++] = (const void*)token_proj_kernel<S, bf16, bf16, false>;
  fns[k++] = (const void*)token_proj_kernel<S, float, bf16, false>;
  if constexpr (S::RESIDENT) {
    fns[k++] = (const void*)edge_attention_bf16_persistent<S, bf16>;
    fns[k++] = (const void*)edge_attention_bf16_persistent<S, float>;
  } else {
    namespace t = tiled;
    using L = t::Layout<S, bf16>;
    constexpr int D = S::D, E = S::E, LDS = L::LDS, LDM = L::LDM;
    constexpr int BD = L::BN_D, BE = L::BN_E;
    constexpr int EPI_D = L::EPI_MEM_LN ? t::EPI_MEM : t::EPI_STORE;
    fns[k++] = (const void*)t::cast_pass<E, LDM, bf16>;
    fns[k++] = (const void*)t::cast_pass<E, LDM, float>;
    fns[k++] = (const void*)t::product_bf16<E, D, BD, D % 8 == 0, EPI_D, LDM, bf16>;
    if constexpr (!L::EPI_MEM_LN) fns[k++] = (const void*)t::mem_pass<S, bf16, LDS, LDM>;
    if constexpr (L::EPI_EDGE_LN) {
      fns[k++] = (const void*)t::product_bf16<D, E, BE, E % 8 == 0, t::EPI_EDGE, LDM, bf16>;
      fns[k++] = (const void*)t::product_bf16<D, E, BE, E % 8 == 0, t::EPI_EDGE, LDM, float>;
    } else {
      fns[k++] = (const void*)t::product_bf16<D, E, BE, E % 8 == 0, t::EPI_STORE, LDM, bf16>;
      fns[k++] = (const void*)t::edge_pass<S, bf16, bf16, LDS>;
      fns[k++] = (const void*)t::edge_pass<S, bf16, float, LDS>;
    }
    if constexpr (L::EPI_LOGITS_OK) {
      fns[k++] = (const void*)t::product_bf16<D, D, BD, D % 8 == 0, t::EPI_LOGITS, LDM, bf16,
                                              S::DH>;
      fns[k++] = (const void*)t::product_bf16<D, D, BD, D % 8 == 0, t::EPI_STORE, LDM, bf16>;
    } else {
      fns[k++] = (const void*)t::product_bf16<D, D, BD, D % 8 == 0, t::EPI_STORE, LDM, bf16>;
      fns[k++] = (const void*)t::logits_pass<S, LDS>;
    }
    fns[k++] = (const void*)t::softmax_stats<S::NH>;
    fns[k++] = (const void*)t::attn_pass<S, LDS>;
  }
  fns[k++] = (const void*)out_proj_kernel<S, bf16, false>;
  return k;
}

// {static shared memory, local memory, registers} of each kernel, in
// kernels_of's order; their count, or minus a CUDA error.
template <class S>
int attrs_of(int* out) {
  const void* fns[16];
  const int count = kernels_of<S>(fns);
  for (int k = 0; k < count; ++k) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[k]);
    if (err != cudaSuccess) return -(int)err;
    out[3 * k] = (int)a.sharedSizeBytes;
    out[3 * k + 1] = (int)a.localSizeBytes;
    out[3 * k + 2] = a.numRegs;
  }
  return count;
}

}  // namespace

// One call = prologue + main + epilogue on `stream`, at the library's widths
// (Shape). Weights and the twelve bias and LayerNorm vectors are bf16, as the
// bf16 network holds them; node and edge are bf16 or float32 (node_bf16,
// edge_bf16). sp, tp, q and attn [B*N, D] are float32 scratch from the caller.
// write_cast: with update_edge == 0, write the input edge to edge_out as
// float32 (the caller passes 0 when it returns a float32 input edge as it
// is). `scratch` holds the tiled route's pair scratch
// (tiled::pair_scratch_bytes(B*N*N); null in the resident layout). Returns
// 0, a CUDA error, ERR_SMEM (before any launch) where the layout does not
// fit the current device's opt-in shared memory, or tiled::ERR_TMA (before
// the main kernel's or the pair steps' launches) where a tensor map cannot
// be encoded.
extern "C" int fused_edge_attention_bf16(
    const void* node, int node_bf16, const void* edge, int edge_bf16,
    const unsigned char* mask,
    const void* wm_e, const void* wm_s, const void* wm_t, const void* bm,
    const void* ln_m_g, const void* ln_m_b, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* we, const void* be,
    const void* ln_e1_g, const void* ln_e1_b, const void* ln_e2_g,
    const void* ln_e2_b, float* sp, float* tp, float* q, float* attn,
    float* out, float* edge_out, void* scratch, int batch, int n, int update_edge,
    int write_cast, void* stream) {
  const Call c{node, edge, node_bf16, edge_bf16, mask,
               (const bf16*)wm_e, (const bf16*)wm_s, (const bf16*)wm_t, (const bf16*)wq,
               (const bf16*)wk, (const bf16*)wv, (const bf16*)wo, (const bf16*)we,
               sp, tp, q, attn, out, edge_out, (unsigned char*)scratch, batch, n,
               update_edge, write_cast, (cudaStream_t)stream};
  const fusion::VecsT<bf16> v{
      (const bf16*)bm, (const bf16*)ln_m_g, (const bf16*)ln_m_b, (const bf16*)bq,
      (const bf16*)bk, (const bf16*)bv, (const bf16*)bo, (const bf16*)be,
      (const bf16*)ln_e1_g, (const bf16*)ln_e1_b, (const bf16*)ln_e2_g, (const bf16*)ln_e2_b};
  return run<fusion::Shape>(c, v);
}

// The widths this library was built for and its layout: {D, E, NH,
// layout_of's 12 values}; the loader checks them against the shape it asked
// for and against the layout's mirror (fusion_attention.py::kernel_smem).
extern "C" void fused_edge_attention_bf16_shape(int* out) {
  out[0] = fusion::Shape::D;
  out[1] = fusion::Shape::E;
  out[2] = fusion::Shape::NH;
  layout_of<fusion::Shape>(out + 3);
}

// {static shared memory, local memory, registers} of each of the library's
// kernels (kernels_of) into out[3 k .. 3 k + 2]; their count, or minus a
// CUDA error.
extern "C" int fused_edge_attention_bf16_attrs(int* out) { return attrs_of<fusion::Shape>(out); }

#ifdef FUSION_TRACE
// The trace (g_trace, 2 x 12 counters) into out; zeroed after with reset.
extern "C" int fused_edge_attention_bf16_trace(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[2 * 12] = {0};
    err = cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));
  }
  return (int)err;
}
#endif

template <class S>
long long scratch_of(long long pairs, long long tokens) {
  if constexpr (S::RESIDENT) return 0;
  else return (long long)fusion::tiled::pair_scratch_bytes<fusion::tiled::Layout<S, __nv_bfloat16>>(pairs, tokens);
}

// The tiled route's pair scratch of a call over `batch` scenes of `n`
// nodes, in bytes (0 in the resident layout).
extern "C" long long fused_edge_attention_bf16_scratch(long long batch, long long n) {
  return scratch_of<fusion::Shape>(batch * n * n, batch * n);
}

template <class S>
int product_entry(int which, const void* a, long long lda, const void* w, float* c,
                  long long ldc, long long rows, void* stream) {
  if constexpr (S::RESIDENT) {
    return -3;
  } else {
    const int err = fusion::tiled::product_alone<S, __nv_bfloat16>(
        which, (const __nv_bfloat16*)a, lda, (const __nv_bfloat16*)w, c, ldc, rows, (cudaStream_t)stream);
    return err != 0 ? err : (int)cudaGetLastError();
  }
}

// One of the tiled route's products alone (tiled::product_alone), on
// `stream`: 0, a CUDA error, tiled::ERR_TMA, or -3 in the resident layout,
// which has no such product.
extern "C" int fused_edge_attention_bf16_product(int which, const void* a, long long lda, const void* w, float* c,
                                long long ldc, long long rows, void* stream) {
  return product_entry<fusion::Shape>(which, a, lda, w, c, ldc, rows, stream);
}
