// Fused edge-conditioned fusion-layer core for Hopper (sm_90a), bf16 operand
// mode on the tensor cores.
//
// Replaces the TPU kernel mind_tpu/ops/fusion_attention.py::_kernel in the
// mode it runs under compute_dtype="bfloat16": node, weights and the first
// layer's edge arrive in bf16, every product of the pair and of the token
// takes bf16 operands and accumulates in float32, and the sums, bias adds,
// the three LayerNorms, ReLU, logits, softmax, the residual edge + eu and
// both outputs stay float32:
//
//   mem[i,j]   = relu(LN(r(edge[i,j]) Wm_e + r(node[i]) Wm_s + r(node[j]) Wm_t + bm))
//   edge'[i,j] = LN(edge[i,j] + relu(LN(r(mem[i,j]) We + be)))   (update_edge)
//   q[j] = r(node[j]) Wq + bq,  k/v[i,j] = r(mem[i,j]) Wk/Wv + bk/bv
//   out[j] = r(softmax_i(q[j].k[i,j] / sqrt(dh), masked keys -> -1e9) v) Wo + bo
//
// where r() rounds a float32 activation to bf16 as it is staged, which is
// what the TPU's matrix unit does with it at default precision. The term
// bk_h . q_h[j] of a logit is the same for every source and cancels in the
// softmax, and the softmax weights sum to 1, so bk is never added and bv is
// added once per target. Node width D, edge width E and NH heads of dh =
// D / NH are compile-time constants of the library, and so is its layout
// (fusion_common.cuh): what follows is the resident layout (D, E multiples
// of 16 from 16 to 128, NH <= 16, dh a multiple of 8). Every other shape
// takes the tiled route of fusion_tiled.cuh (pair tiles of 128 pairs on
// wgmma.m64nNk16 with the weight read transposed from its own layout, fed
// by TMA through a ring of mbarrier-signalled stages); run picks it at
// compile time.
//
// Bound on the H100 (B = 8, N = 129, 128 / 128 / 8, edge update, float32 edge
// in): the call reads 68.2 MB and writes 68.2 MB of edge, 0.041 ms at 3.35
// TB/s, against 0.018 ms for 17.65 GFLOP at 989 TFLOP/s of bf16. The mode is
// bound by bytes, so the design moves each edge byte once, in full 32-byte
// sectors, and hides the copies behind the products:
//
// - (scene, target) pairs are flattened into B*N columns and a block owns 8
//   consecutive ones (129 full tiles at B = 8, N = 129: one wave on 132 SMs);
//   sources stream in chunks of 8, so a chunk is 64 rows;
// - the four per-pair weights Wm_e [E x D], We [D x E], Wk and Wv [D x D] stay
//   resident in shared memory in bf16 (4 x 32 KB at 128 / 128), transposed to
//   [n][k] as they are staged, in the K-major core-matrix layout that wgmma
//   reads through a descriptor; the per-token products (Wm_s, Wm_t, Wq, Wo)
//   run once per call in fusion_common.cuh's kernels;
// - a block is two warpgroups; they take alternate chunks, each with its own
//   operand tile and staging buffer, so every scheduler holds two warps in
//   different phases and one group's LayerNorm epilogue runs under the
//   other's products;
// - each product is K / 16 wgmma.mma_async.m64nNk16 (bf16 in, float32
//   accumulate; N = D, or E for the edge update) over the group's 64-row
//   tile, and its accumulator, 64 x N float32, is N / 2 registers a thread
//   (64 at 128). A warp holds 16 rows of it (2 sources x 8 targets) and a row
//   lies in the 4 lanes of a quad, so LayerNorm and the per-head q.k sums are
//   two shuffles;
// - the warp copies its own rows of the next chunk with 16-byte cp.async into
//   a raw staging buffer while it works on the current one; float32 rows are
//   rounded to bf16 as they move from the staging buffer to the operand tile.
//   The main loop has no block-wide barrier, only two 128-thread barriers per
//   chunk inside a group (tile complete, mem complete);
// - mem lives only as the bf16 operand tile of the next three products, and
//   overwrites the edge chunk's tile in place once the first product is done;
// - the softmax is online per thread (its two sources per chunk) and the
//   eight warps' partial states are merged once at the end.

#include "fusion_common.cuh"
#include "fusion_tiled.cuh"

namespace {

using namespace fusion;
typedef __nv_bfloat16 bf16;

constexpr int TJ = 8;                           // (scene, target) columns per block
constexpr int R = TI * TJ;                      // (source, target) rows per chunk
constexpr int NTB = 256;                        // threads per block: 2 warpgroups
constexpr int NW = NTB / 32;
// Operand tiles lie in shared memory as wgmma's K-major layout without
// swizzle: 8 x 8 core matrices of 128 contiguous bytes (8 rows of 16 bytes);
// the core matrices of one group of 8 k follow each other along the rows
// (stride SBO = 128 bytes), the k groups are LBO = rows x 16 bytes apart.
constexpr int CORE = 128;                       // bytes of a core matrix
constexpr int A_LBO = R * 16;                   // 1,024: 64-row activation tile

// The block's layout for the library's widths (bytes).
template <class S>
struct LayoutB {
  static constexpr int D = S::D, E = S::E, NH = S::NH;
  static constexpr int NMAX = D > E ? D : E;
  static constexpr int OFF_WME = 0;                       // Wm_e as [D][E]
  static constexpr int OFF_WE = OFF_WME + D * E * 2;      // We as [E][D]
  static constexpr int OFF_WK = OFF_WE + E * D * 2;       // Wk as [D][D]
  static constexpr int OFF_WV = OFF_WK + D * D * 2;       // Wv as [D][D]
  static constexpr int OFF_T = OFF_WV + D * D * 2;        // per group: edge chunk as bf16, then mem
  static constexpr int TILE_BYTES = R * NMAX * 2;
  static constexpr int OFF_RAW = OFF_T + 2 * TILE_BYTES;  // per group: next chunk as it lies in memory
  static constexpr int RAW_BYTES = R * E * 4;
  // after the main loop the staging buffers hold the merge scratch
  static constexpr int MRG_FLOATS = NW * TJ * (D + 2 * NH);
  static constexpr int RAW_REGION =
      2 * RAW_BYTES > MRG_FLOATS * 4 ? 2 * RAW_BYTES : MRG_FLOATS * 4;
  static constexpr size_t SMEM_BYTES = OFF_RAW + RAW_REGION;   // 229,376 at 128 / 128 / 8
  static_assert(SMEM_BYTES <= 232448, "the layout must fit the H100's opt-in shared memory");
};

// Byte offset of element (row, k) in a tile of `lbo / 16` rows.
__device__ __forceinline__ int tile_off(int row, int k, int lbo) {
  return (k >> 3) * lbo + (row >> 3) * CORE + (row & 7) * 16 + (k & 7) * 2;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// 64-bit wgmma matrix descriptor: start address, leading (k-group) and stride
// (row-group) byte offsets in 16-byte units, no swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(CORE >> 4) << 32);
}
__device__ __forceinline__ void fence_proxy_async() {
  // shared-memory writes of ordinary stores become visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void group_barrier(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(group + 1) : "memory");
}

// acc (+)= a[64 x 16] b[16 x N] from the two descriptors, one k step: one
// specialization per N, each naming its N / 2 accumulator registers.
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16(float (*acc)[4], uint64_t da, uint64_t db,
                                               int accumulate);
#define ACC4(i) "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
#define FUSION_WGMMA(N, REGS, DA, DB, P, ...)                                              \
  template <>                                                                              \
  __device__ __forceinline__ void wgmma_m64nNk16<N>(float (*acc)[4], uint64_t da,          \
                                                    uint64_t db, int accumulate) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                            \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "               \
                 "{" REGS "}, " DA ", " DB ", p, 1, 1, 0, 0;\n}\n"                         \
                 : __VA_ARGS__                                                             \
                 : "l"(da), "l"(db), "r"(accumulate));                                     \
  }
FUSION_WGMMA(16, "%0, %1, %2, %3, %4, %5, %6, %7", "%8", "%9", "%10",
             ACC4(0), ACC4(1))
FUSION_WGMMA(32, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15", "%16", "%17", "%18",
             ACC4(0), ACC4(1), ACC4(2), ACC4(3))
FUSION_WGMMA(48, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23", "%24", "%25", "%26",
             ACC4(0), ACC4(1), ACC4(2), ACC4(3), ACC4(4), ACC4(5))
FUSION_WGMMA(64, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31", "%32", "%33", "%34",
             ACC4(0), ACC4(1), ACC4(2), ACC4(3), ACC4(4), ACC4(5), ACC4(6), ACC4(7))
FUSION_WGMMA(80, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39", "%40", "%41", "%42",
             ACC4(0), ACC4(1), ACC4(2), ACC4(3), ACC4(4), ACC4(5), ACC4(6), ACC4(7), ACC4(8), ACC4(9))
FUSION_WGMMA(96, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47", "%48", "%49", "%50",
             ACC4(0), ACC4(1), ACC4(2), ACC4(3), ACC4(4), ACC4(5), ACC4(6), ACC4(7), ACC4(8), ACC4(9), ACC4(10), ACC4(11))
FUSION_WGMMA(112, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55", "%56", "%57", "%58",
             ACC4(0), ACC4(1), ACC4(2), ACC4(3), ACC4(4), ACC4(5), ACC4(6), ACC4(7), ACC4(8), ACC4(9), ACC4(10), ACC4(11), ACC4(12), ACC4(13))
FUSION_WGMMA(128, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63", "%64", "%65", "%66",
             ACC4(0), ACC4(1), ACC4(2), ACC4(3), ACC4(4), ACC4(5), ACC4(6), ACC4(7), ACC4(8), ACC4(9), ACC4(10), ACC4(11), ACC4(12), ACC4(13), ACC4(14), ACC4(15))
#undef FUSION_WGMMA
#undef ACC4

// acc = a[64 x K] w[K x N] for the warpgroup: a is its 64-row tile, w a
// resident weight as [n][k], both in the core-matrix layout. A thread of
// warp w holds rows 16w + lane/4 (acc[nt][0..1]) and + 8 (acc[nt][2..3]),
// columns 8nt + 2(lane%4) + {0,1}, nt < N / 8. Returns when the product is
// complete.
template <int N, int K, int NG>
__device__ __forceinline__ void warpgroup_mma(const void* a, const void* w, float acc[NG][4]) {
  constexpr int B_LBO = N * 16;                 // N-row (n) weight tile
  const uint64_t da = smem_desc(a, A_LBO), db = smem_desc(w, B_LBO);
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[nt][e])::"memory");
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_m64nNk16<N>(acc, da + (uint64_t)(ks * 2 * (A_LBO >> 4)),
                      db + (uint64_t)(ks * 2 * (B_LBO >> 4)), ks > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[nt][e])::"memory");
}

// Two adjacent values of a float32 or bf16 array in global memory.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two-pass LayerNorm of one W-wide row held as W / 4 values (x[nt][0..1],
// nt < W / 8) in each lane of a quad.
template <int W>
__device__ __forceinline__ void ln_row_quad(float x[][2], const bf16* __restrict__ g,
                                            const bf16* __restrict__ b, int q2) {
  float s = 0.f;
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) s += x[nt][0] + x[nt][1];
  const float mean = quad_sum(s) * (1.f / W);
  float sq = 0.f;
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) {
    const float d0 = x[nt][0] - mean, d1 = x[nt][1] - mean;
    sq = fmaf(d0, d0, sq);
    sq = fmaf(d1, d1, sq);
  }
  const float inv = rsqrtf(quad_sum(sq) * (1.f / W) + LN_EPS);
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) {
    const float2 gv = load_pair(g + nt * 8 + q2);
    const float2 bv = load_pair(b + nt * 8 + q2);
    x[nt][0] = (x[nt][0] - mean) * inv * gv.x + bv.x;
    x[nt][1] = (x[nt][1] - mean) * inv * gv.y + bv.y;
  }
}

// The same pair out of shared memory (no read-only global path there).
__device__ __forceinline__ float2 staged_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 staged_pair(const bf16* p) { return load_pair(p); }

// A resident weight w [K][N] (row-major, as the network holds it) into a
// tile [n][k]: a thread takes one k and 8 consecutive n (16 bytes of row k)
// and stores them to 8 rows of the tile. Every block copies the same
// weights: each starts at another row, so they do not queue on one L2 line.
template <int K, int N>
__device__ __forceinline__ void stage_weight(const bf16* __restrict__ src, unsigned char* dst,
                                             int tid) {
  for (int idx = tid; idx < K * N / 8; idx += NTB) {
    const int k = ((unsigned)idx % (unsigned)K + blockIdx.x) % (unsigned)K;
    const int n0 = ((unsigned)idx / (unsigned)K) * 8;
    const uint4 piece = __ldg(reinterpret_cast<const uint4*>(src + k * N + n0));
    const bf16* e = reinterpret_cast<const bf16*>(&piece);
#pragma unroll
    for (int x = 0; x < 8; ++x)
      *reinterpret_cast<bf16*>(dst + tile_off(n0 + x, k, N * 16)) = e[x];
  }
}

template <class S, typename EdgeT>
__global__ void __launch_bounds__(NTB, 1)
edge_attention_bf16_kernel(const EdgeT* __restrict__ edge,
                           const unsigned char* __restrict__ mask,
                           const bf16* __restrict__ wm_e, const bf16* __restrict__ we,
                           const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                           const float* __restrict__ sp, const float* __restrict__ tp,
                           const float* __restrict__ q, VecsT<bf16> v,
                           float* __restrict__ attn, float* __restrict__ edge_out,
                           int n, int cols, int update_edge, int write_cast) {
  using L = LayoutB<S>;
  constexpr int D = S::D, E = S::E, NH = S::NH, DH = S::DH, NG = L::NMAX / 8;
  constexpr int GD = D / 8, GE = E / 8;    // 8-column groups of a D- and an E-wide row
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* Mrg = reinterpret_cast<float*>(smem + L::OFF_RAW);
  __shared__ long long s_base[TJ];   // element offset of edge[b, 0, j, 0]
  __shared__ int s_tok0[TJ];         // b * n, or -1 for a column past the end

  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid >> 7;          // which chunks: group, group + 2, ...
  const int warp = (tid >> 5) & 3;     // warp within the group: which rows of a chunk
  // the group's operand tile: the edge chunk, then mem over it, row by row
  unsigned char* Tile = smem + L::OFF_T + group * L::TILE_BYTES;
  EdgeT* Raw = reinterpret_cast<EdgeT*>(smem + L::OFF_RAW + group * L::RAW_BYTES);
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int c0 = blockIdx.x * TJ;
  constexpr int PIECE = 16 / sizeof(EdgeT);     // elements per 16-byte piece
  constexpr int PPR = E / PIECE;                // pieces per row

  if (tid < TJ) {
    const int c = c0 + tid;
    const int b = c / n, j = c % n;
    s_base[tid] = ((long long)b * n * n + j) * E;
    s_tok0[tid] = c < cols ? b * n : -1;
  }
  // resident weights, transposed to [n][k] as they are staged
  stage_weight<E, D>(wm_e, smem + L::OFF_WME, tid);
  if (update_edge) stage_weight<D, E>(we, smem + L::OFF_WE, tid);
  stage_weight<D, D>(wk, smem + L::OFF_WK, tid);
  stage_weight<D, D>(wv, smem + L::OFF_WV, tid);
  __syncthreads();   // s_base, s_tok0

  // the warp's rows of a chunk: local row lr = 0..15 is source 2 warp + lr / 8,
  // target lr % 8
  auto load_raw = [&](int i0) {
#pragma unroll 4
    for (int idx = lane; idx < 16 * PPR; idx += 32) {
      const int lr = idx / PPR, p = idx % PPR;
      const int i = i0 + 2 * warp + (lr >> 3), jj = lr & 7;
      const bool ok = i < n && s_tok0[jj] >= 0;
      const EdgeT* src = edge + s_base[jj] + (long long)i * n * E + p * PIECE;
      cp_async16(Raw + (warp * 16 + lr) * E + p * PIECE, ok ? src : edge, ok);
    }
    cp_async_commit();
  };

  // the thread's target, and its two sources per chunk
  const int tok0 = s_tok0[g];
  const bool c_ok = tok0 >= 0;
  const int c = c0 + g;

  float run_m[NH], run_s[NH], o[GD][2];
#pragma unroll
  for (int h = 0; h < NH; ++h) { run_m[h] = -INFINITY; run_s[h] = 0.f; }
#pragma unroll
  for (int nt = 0; nt < GD; ++nt) o[nt][0] = o[nt][1] = 0.f;

  float acc[NG][4];
  const int n_chunks = (n + TI - 1) / TI;
  if (group < n_chunks) load_raw(group * TI);
  fence_proxy_async();
  __syncthreads();   // weights resident for every warp

  for (int ch = group; ch < n_chunks; ch += 2) {
    const int i0 = ch * TI;
    cp_async_wait<0>();
    __syncwarp();
    // ---- staging buffer -> bf16 operand tile (and the float32 cast out) ----
#pragma unroll 4
    for (int idx = lane; idx < 16 * (E / 4); idx += 32) {
      const int lr = idx / (E / 4), p4 = (idx % (E / 4)) * 4;
      const EdgeT* src = Raw + (warp * 16 + lr) * E + p4;
      const float2 lo = staged_pair(src), hi = staged_pair(src + 2);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          Tile + tile_off(warp * 16 + lr, p4, A_LBO));
      dst[0] = __floats2bfloat162_rn(lo.x, lo.y);
      dst[1] = __floats2bfloat162_rn(hi.x, hi.y);
      if (write_cast) {
        const int i = i0 + 2 * warp + (lr >> 3), jj = lr & 7;
        if (i < n && s_tok0[jj] >= 0)
          *reinterpret_cast<float4*>(edge_out + s_base[jj] + (long long)i * n * E + p4) =
              make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
    __syncwarp();
    if (ch + 2 < n_chunks) load_raw(i0 + 2 * TI);

    fence_proxy_async();
    group_barrier(group);   // the four warps' rows make the group's tile

    // ---- mem = relu(LN(edge Wm_e + node_i Wm_s + node_j Wm_t + bm)) -> bf16 ----
    warpgroup_mma<D, E, NG>(Tile, smem + L::OFF_WME, acc);   // complete: mem may overwrite the tile
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + 2 * warp + hh;
      const bool ok = c_ok && i < n;
      float x[GD][2];
#pragma unroll
      for (int nt = 0; nt < GD; ++nt) {
        float2 a = make_float2(0.f, 0.f), t = make_float2(0.f, 0.f);
        if (ok) {
          a = load_pair(sp + (size_t)(tok0 + i) * D + nt * 8 + q2);
          t = load_pair(tp + (size_t)c * D + nt * 8 + q2);
        }
        x[nt][0] = acc[nt][hh * 2] + a.x + t.x;
        x[nt][1] = acc[nt][hh * 2 + 1] + a.y + t.y;
      }
      ln_row_quad<D>(x, v.ln_m_g, v.ln_m_b, q2);
#pragma unroll
      for (int nt = 0; nt < GD; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(
            Tile + tile_off(warp * 16 + hh * 8 + g, nt * 8 + q2, A_LBO)) =
            __floats2bfloat162_rn(fmaxf(x[nt][0], 0.f), fmaxf(x[nt][1], 0.f));
    }
    fence_proxy_async();
    group_barrier(group);   // mem of all 64 rows is in the tile

    // ---- edge' = LN(edge + relu(LN(mem We + be))) ----
    if (update_edge) {
      warpgroup_mma<E, D, NG>(Tile, smem + L::OFF_WE, acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 2 * warp + hh;
        const bool ok = c_ok && i < n;
        float x[GE][2];
#pragma unroll
        for (int nt = 0; nt < GE; ++nt) {
          const float2 be = load_pair(v.be + nt * 8 + q2);
          x[nt][0] = acc[nt][hh * 2] + be.x;
          x[nt][1] = acc[nt][hh * 2 + 1] + be.y;
        }
        ln_row_quad<E>(x, v.ln_e1_g, v.ln_e1_b, q2);
        const size_t off = ok ? (size_t)(s_base[g] + (long long)i * n * E) : 0;
#pragma unroll
        for (int nt = 0; nt < GE; ++nt) {
          const float2 e = load_pair(edge + off + nt * 8 + q2);
          x[nt][0] = fmaxf(x[nt][0], 0.f) + e.x;
          x[nt][1] = fmaxf(x[nt][1], 0.f) + e.y;
        }
        ln_row_quad<E>(x, v.ln_e2_g, v.ln_e2_b, q2);
        if (ok) {
#pragma unroll
          for (int nt = 0; nt < GE; ++nt)
            *reinterpret_cast<float2*>(edge_out + off + nt * 8 + q2) =
                make_float2(x[nt][0], x[nt][1]);
        }
      }
    }

    // ---- k = mem Wk; logits q[j] . k[i,j] / sqrt(dh) per head ----
    warpgroup_mma<D, D, NG>(Tile, smem + L::OFF_WK, acc);
    float lg[2][NH];
    {
      float part[2][NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) part[0][h] = part[1][h] = 0.f;
#pragma unroll
      for (int nt = 0; nt < GD; ++nt) {
        float2 qv = make_float2(0.f, 0.f);
        if (c_ok) qv = load_pair(q + (size_t)c * D + nt * 8 + q2);
        // an 8-column group lies in one head: dh is a multiple of 8
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          part[hh][nt * 8 / DH] += acc[nt][hh * 2] * qv.x + acc[nt][hh * 2 + 1] * qv.y;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + 2 * warp + hh;
        const bool key_on = c_ok && i < n && mask[c_ok && i < n ? tok0 + i : 0];
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float s = quad_sum(part[hh][h]) * S::QK_SCALE;
          lg[hh][h] = key_on ? s : MASKED;
        }
      }
    }

    // ---- v = mem Wv; online softmax over the thread's two sources ----
    warpgroup_mma<D, D, NG>(Tile, smem + L::OFF_WV, acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (i0 + 2 * warp + hh < n) {     // uniform over the warp
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float m_new = fmaxf(run_m[h], lg[hh][h]);
          const float corr = expf(run_m[h] - m_new);
          const float p = expf(lg[hh][h] - m_new);
          run_s[h] = run_s[h] * corr + p;
          run_m[h] = m_new;
#pragma unroll
          for (int t = 0; t < DH / 8; ++t) {
            const int nt = (DH / 8) * h + t;
            o[nt][0] = fmaf(o[nt][0], corr, p * acc[nt][hh * 2]);
            o[nt][1] = fmaf(o[nt][1], corr, p * acc[nt][hh * 2 + 1]);
          }
        }
      }
    }
    __syncwarp();
  }

  // ---- merge the eight warps' softmax states; attn[c] = sum_i p v / sum_i p ----
  __syncthreads();   // every warp is out of the loop: the staging buffers are free
  const int wid = tid >> 5;
  float* mrg_o = Mrg;                            // [NW][TJ][D]
  float* mrg_m = Mrg + NW * TJ * D;              // [NW][TJ][NH]
  float* mrg_s = mrg_m + NW * TJ * NH;           // [NW][TJ][NH]
#pragma unroll
  for (int nt = 0; nt < GD; ++nt)
    *reinterpret_cast<float2*>(mrg_o + (wid * TJ + g) * D + nt * 8 + q2) =
        make_float2(o[nt][0], o[nt][1]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      mrg_m[(wid * TJ + g) * NH + h] = run_m[h];
      mrg_s[(wid * TJ + g) * NH + h] = run_s[h];
    }
  }
  __syncthreads();
  // warp jj finishes target jj: lane l the 4 columns 4l..4l+3, one head's
  const int jj = tid >> 5, col0 = lane * 4, h = col0 / DH;
  if (D == 128 || col0 < D) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, mrg_m[(w * TJ + jj) * NH + h]);
    float sum = 0.f, val[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(mrg_m[(w * TJ + jj) * NH + h] - mx);
      sum = fmaf(mrg_s[(w * TJ + jj) * NH + h], f, sum);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        val[e] = fmaf(mrg_o[(w * TJ + jj) * D + col0 + e], f, val[e]);
    }
    if (s_tok0[jj] >= 0) {
      const float inv = 1.f / sum;
      *reinterpret_cast<float4*>(attn + (size_t)(c0 + jj) * D + col0) =
          make_float4(val[0] * inv, val[1] * inv, val[2] * inv, val[3] * inv);
    }
  }
}

template <class S, typename EdgeT>
int launch_main(const void* edge, const unsigned char* mask, const bf16* wm_e,
                const bf16* we, const bf16* wk, const bf16* wv, const float* sp,
                const float* tp, const float* q, const VecsT<bf16>& v, float* attn,
                float* edge_out, unsigned char* scratch, int n, int cols, int update_edge,
                int write_cast, cudaStream_t s) {
  if constexpr (S::RESIDENT) {
    constexpr size_t SMEM_BYTES = LayoutB<S>::SMEM_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        edge_attention_bf16_kernel<S, EdgeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    edge_attention_bf16_kernel<S, EdgeT><<<(cols + TJ - 1) / TJ, NTB, SMEM_BYTES, s>>>(
        static_cast<const EdgeT*>(edge), mask, wm_e, we, wk, wv, sp, tp, q, v, attn,
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
// M, L)}: 11 values, as fusion_attention.cu's
template <class S>
void layout_of(int* out) {
  if constexpr (S::RESIDENT) {
    const int v[11] = {smem_bytes<S>(), 0, TJ, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < 11; ++k) out[k] = v[k];
  } else {
    using L = tiled::Layout<S, bf16>;
    const int v[11] = {L::SMEM_BYTES, 1, 0, 0, tiled::BM, L::BN, L::STAGES,
                       (L::EPI_MEM_LN ? 1 : 0) | (L::EPI_EDGE_LN ? 2 : 0), L::PAIR_S, L::PAIR_M,
                       L::PAIR_L};
    for (int k = 0; k < 11; ++k) out[k] = v[k];
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
    fns[k++] = (const void*)edge_attention_bf16_kernel<S, bf16>;
    fns[k++] = (const void*)edge_attention_bf16_kernel<S, float>;
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
// the pair steps' launches) where a tensor map cannot be encoded.
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
// layout_of's 11 values}; the loader checks them against the shape it asked
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
