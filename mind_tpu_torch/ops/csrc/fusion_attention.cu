// Fused edge-conditioned fusion-layer core for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel mind_tpu/ops/fusion_attention.py::_kernel (the
// Pallas kernel launched by fused_edge_attention). Per scene b and target j:
//
//   mem[i,j]  = relu(LN(edge[i,j] Wm_e + node[i] Wm_s + node[j] Wm_t + bm))
//   edge'[i,j] = LN(edge[i,j] + relu(LN(mem[i,j] We + be)))   (update_edge)
//   q[j] = node[j] Wq + bq,  k/v[i,j] = mem[i,j] Wk/Wv + bk/bv
//   out[j] = softmax_i(q[j].k[i,j] / sqrt(dh), masked keys -> -1e9) v  Wo + bo
//
// with 8 heads of dh = 16 and D = E = 128. Every projection, including
// node Wm_s, node Wm_t, node Wq and out Wo, is computed here.
//
// Bound on the H100 (B = 8, N = 129): 2.18 GFLOP per scene with the edge
// update (1.64 without), 17 MB of edge traffic per scene. At 67 TFLOP/s of
// non-tensor float32 against 3.35 TB/s of HBM the work is compute-bound
// (~128 flop per edge byte), so the design keeps mem/k/v out of device
// memory entirely and spends its effort on the four 128x128 products per
// (i, j) pair:
//
// - grid (ceil(N / TJ), B); one block of 256 threads owns TJ = 8 targets;
// - sources stream in chunks of TI = 8, so a chunk is R = 64 (i, j) rows;
// - each product is a [64 x 128] x [128 x 128] SIMT GEMM out of shared
//   memory: warp w owns rows 8w..8w+7 (one source, all 8 targets), lane l
//   owns columns l + 32c (c = 0..3), so LayerNorm and the per-head q.k
//   dot products are warp shuffles over the registers that hold the row;
// - the weight matrix of each product is staged whole in shared memory
//   (64 KB), reloaded per chunk from L2;
// - softmax is online (running max / sum / [TJ, D] accumulator per head
//   across chunks), so only the edge' rows and the [TJ, D] output leave
//   the block;
// - ragged N is masked in the kernel: padded sources are never read into
//   the softmax and padded targets are never written.
//
// Numerics: plain float32 FMA, no TF32 and no bf16; LayerNorm is two-pass
// (mean, then mean of squared deviations) as in fused_edge_attention_ref.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 128;          // node width == edge width
constexpr int NH = 8;           // heads
constexpr int DH = D / NH;      // 16
constexpr int TJ = 8;           // targets per block
constexpr int TI = 8;           // sources per chunk
constexpr int R = TI * TJ;      // rows per chunk (64)
constexpr int NT = 256;         // threads per block
constexpr int RPW = R / (NT / 32);  // rows per warp (8)
constexpr float LN_EPS = 1e-5f;

struct Weights {
  const float *wm_e, *wm_s, *wm_t, *bm, *ln_m_g, *ln_m_b;
  const float *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
  const float *we, *be, *ln_e1_g, *ln_e1_b, *ln_e2_g, *ln_e2_b;
};

// shared-memory layout (floats)
constexpr int OFF_W = 0;                 // [128][128] staged weight
constexpr int OFF_A = OFF_W + D * D;     // [R][128] edge chunk, later v
constexpr int OFF_M = OFF_A + R * D;     // [R][128] mem
constexpr int OFF_NI = OFF_M + R * D;    // [TI][128] source nodes
constexpr int OFF_SP = OFF_NI + TI * D;  // [TI][128] node_i Wm_s
constexpr int OFF_NJ = OFF_SP + TI * D;  // [TJ][128] target nodes, later out
constexpr int OFF_TP = OFF_NJ + TJ * D;  // [TJ][128] node_j Wm_t + bm
constexpr int OFF_Q = OFF_TP + TJ * D;   // [TJ][128] q
constexpr int OFF_L = OFF_Q + TJ * D;    // [R][NH] logits
constexpr int SMEM_FLOATS = OFF_L + R * NH;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy a [128][128] weight matrix (global, row-major [in][out]) to smem.
__device__ __forceinline__ void stage_weight(float* ws, const float* wg) {
  const float4* src = reinterpret_cast<const float4*>(wg);
  float4* dst = reinterpret_cast<float4*>(ws);
  for (int idx = threadIdx.x; idx < D * D / 4; idx += NT) dst[idx] = __ldg(src + idx);
}

// out[r][c] = sum_k in[r][k] w[k][c] (+ bias[c]) for 8 rows, w in global.
__device__ __forceinline__ void small_mm(const float* in, const float* wg,
                                         const float* bias, float* out) {
  const int col = threadIdx.x & (D - 1);
  const int r0 = (threadIdx.x >> 7) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < D; ++k) {
    const float w = __ldg(wg + k * D + col);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = fmaf(in[(r0 + r) * D + k], w, acc[r]);
  }
  const float b = bias ? __ldg(bias + col) : 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) out[(r0 + r) * D + col] = acc[r] + b;
}

// acc[rr][c] = sum_k A[8w+rr][k] W[k][l+32c] for the warp's 8 rows.
__device__ __forceinline__ void warp_gemm(const float* a, const float* ws,
                                          float acc[RPW][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[rr][c] = 0.f;
  const float* arow = a + warp * RPW * D;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 av[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr)
      av[rr] = *reinterpret_cast<const float4*>(arow + rr * D + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = ws[(k + kk) * D + lane + 32 * c];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float x = kk == 0 ? av[rr].x : kk == 1 ? av[rr].y
                      : kk == 2 ? av[rr].z : av[rr].w;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[rr][c] = fmaf(x, wv[c], acc[rr][c]);
      }
    }
  }
}

// Two-pass LayerNorm of one 128-wide row held as 4 values per lane.
__device__ __forceinline__ void ln_row(float v[4], const float* g, const float* b) {
  const int lane = threadIdx.x & 31;
  const float mean = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.f / D);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) { const float d = v[c] - mean; sq = fmaf(d, d, sq); }
  const float inv = rsqrtf(warp_sum(sq) * (1.f / D) + LN_EPS);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = lane + 32 * c;
    v[c] = (v[c] - mean) * inv * __ldg(g + col) + __ldg(b + col);
  }
}

__global__ void __launch_bounds__(NT, 1)
fused_edge_attention_kernel(const float* __restrict__ node,
                            const float* __restrict__ edge,
                            const unsigned char* __restrict__ mask,
                            Weights w, float* __restrict__ out,
                            float* __restrict__ edge_out, int n,
                            int update_edge) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ws = smem + OFF_W;
  float* As = smem + OFF_A;
  float* Ms = smem + OFF_M;
  float* NIs = smem + OFF_NI;
  float* SPs = smem + OFF_SP;
  float* NJs = smem + OFF_NJ;
  float* TPs = smem + OFF_TP;
  float* Qs = smem + OFF_Q;
  float* Ls = smem + OFF_L;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * TJ;
  const int b = blockIdx.y;
  const float* node_b = node + (size_t)b * n * D;
  const float* edge_b = edge + (size_t)b * n * n * D;
  float* edge_out_b = edge_out + (size_t)b * n * n * D;
  const unsigned char* mask_b = mask + (size_t)b * n;

  // prologue: target nodes -> tar_proj (+bm) and q
  for (int idx = tid; idx < TJ * D; idx += NT) {
    const int j = j0 + idx / D;
    NJs[idx] = j < n ? node_b[(size_t)j * D + idx % D] : 0.f;
  }
  __syncthreads();
  small_mm(NJs, w.wm_t, w.bm, TPs);
  small_mm(NJs, w.wq, w.bq, Qs);
  __syncthreads();

  // online-softmax state: thread owns (target jj, head h) and 4 of its dims
  const int sm_pair = tid >> 2;
  const int sm_j = sm_pair / NH, sm_h = sm_pair % NH, sm_d0 = (tid & 3) * 4;
  float run_max = -INFINITY, run_sum = 0.f;
  float run_acc[4] = {0.f, 0.f, 0.f, 0.f};

  // the row this warp owns: source il = warp, targets jj = 0..7
  const int il = warp;
  float acc[RPW][4];

  for (int i0 = 0; i0 < n; i0 += TI) {
    // ---- load the edge chunk and the source nodes, stage Wm_e ----
    for (int idx = tid; idx < R * D / 4; idx += NT) {
      const int r = idx / (D / 4), e4 = idx % (D / 4);
      const int i = i0 + r / TJ, j = j0 + r % TJ;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && j < n)
        v = __ldg(reinterpret_cast<const float4*>(edge_b + ((size_t)i * n + j) * D) + e4);
      reinterpret_cast<float4*>(As)[idx] = v;
    }
    for (int idx = tid; idx < TI * D; idx += NT) {
      const int i = i0 + idx / D;
      NIs[idx] = i < n ? node_b[(size_t)i * D + idx % D] : 0.f;
    }
    stage_weight(Ws, w.wm_e);
    __syncthreads();
    small_mm(NIs, w.wm_s, nullptr, SPs);
    __syncthreads();

    // ---- mem = relu(LN(edge Wm_e + node_i Wm_s + node_j Wm_t + bm)) ----
    warp_gemm(As, Ws, acc);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = lane + 32 * c;
        v[c] = acc[rr][c] + SPs[il * D + col] + TPs[rr * D + col];
      }
      ln_row(v, w.ln_m_g, w.ln_m_b);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ms[(il * TJ + rr) * D + lane + 32 * c] = fmaxf(v[c], 0.f);
    }
    __syncthreads();

    // ---- edge' = LN(edge + relu(LN(mem We + be))) ----
    if (update_edge) {
      stage_weight(Ws, w.we);
      __syncthreads();
      warp_gemm(Ms, Ws, acc);
      const int i = i0 + il;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = acc[rr][c] + __ldg(w.be + lane + 32 * c);
        ln_row(v, w.ln_e1_g, w.ln_e1_b);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = fmaxf(v[c], 0.f) + As[(il * TJ + rr) * D + lane + 32 * c];
        ln_row(v, w.ln_e2_g, w.ln_e2_b);
        const int j = j0 + rr;
        if (i < n && j < n) {
          float* dst = edge_out_b + ((size_t)i * n + j) * D;
#pragma unroll
          for (int c = 0; c < 4; ++c) dst[lane + 32 * c] = v[c];
        }
      }
      __syncthreads();
    }

    // ---- k = mem Wk + bk; per-head logits q[j].k[i,j] / sqrt(dh) ----
    stage_weight(Ws, w.wk);
    __syncthreads();
    warp_gemm(Ms, Ws, acc);
    {
      const int i = i0 + il;
      const bool key_on = i < n && mask_b[i < n ? i : 0];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = lane + 32 * c;
          float p = (acc[rr][c] + __ldg(w.bk + col)) * Qs[rr * D + col];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
          if ((lane & 15) == 0) {
            const int h = 2 * c + (lane >> 4);
            Ls[(il * TJ + rr) * NH + h] = key_on ? p * (1.f / 4.f) : -1e9f;
          }
        }
      }
    }
    __syncthreads();

    // ---- v = mem Wv + bv, into the (now free) edge buffer ----
    stage_weight(Ws, w.wv);
    __syncthreads();
    warp_gemm(Ms, Ws, acc);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = lane + 32 * c;
        As[(il * TJ + rr) * D + col] = acc[rr][c] + __ldg(w.bv + col);
      }
    __syncthreads();

    // ---- online softmax over this chunk's sources ----
    for (int s = 0; s < TI && i0 + s < n; ++s) {
      const int r = s * TJ + sm_j;
      const float logit = Ls[r * NH + sm_h];
      const float m_new = fmaxf(run_max, logit);
      const float corr = expf(run_max - m_new);
      const float p = expf(logit - m_new);
      run_sum = run_sum * corr + p;
      const float4 v = *reinterpret_cast<const float4*>(As + r * D + sm_h * DH + sm_d0);
      run_acc[0] = fmaf(run_acc[0], corr, p * v.x);
      run_acc[1] = fmaf(run_acc[1], corr, p * v.y);
      run_acc[2] = fmaf(run_acc[2], corr, p * v.z);
      run_acc[3] = fmaf(run_acc[3], corr, p * v.w);
      run_max = m_new;
    }
    __syncthreads();
  }

  // ---- out = (softmax-weighted v) Wo + bo ----
  const float inv = 1.f / run_sum;
#pragma unroll
  for (int d = 0; d < 4; ++d) NJs[sm_j * D + sm_h * DH + sm_d0 + d] = run_acc[d] * inv;
  __syncthreads();
  small_mm(NJs, w.wo, w.bo, TPs);
  __syncthreads();
  for (int idx = tid; idx < TJ * D; idx += NT) {
    const int j = j0 + idx / D;
    if (j < n) out[((size_t)b * n + j) * D + idx % D] = TPs[idx];
  }
}

}  // namespace

extern "C" int fused_edge_attention_f32(
    const float* node, const float* edge, const unsigned char* mask,
    const float* wm_e, const float* wm_s, const float* wm_t, const float* bm,
    const float* ln_m_g, const float* ln_m_b, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, const float* we, const float* be,
    const float* ln_e1_g, const float* ln_e1_b, const float* ln_e2_g,
    const float* ln_e2_b, float* out, float* edge_out, int batch, int n,
    int update_edge, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_edge_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Weights w{wm_e, wm_s, wm_t, bm, ln_m_g, ln_m_b, wq, bq, wk, bk, wv, bv,
            wo, bo, we, be, ln_e1_g, ln_e1_b, ln_e2_g, ln_e2_b};
  dim3 grid((n + TJ - 1) / TJ, batch);
  fused_edge_attention_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      node, edge, mask, w, out, edge_out, n, update_edge);
  return (int)cudaGetLastError();
}

extern "C" int fused_edge_attention_width() { return D; }
extern "C" int fused_edge_attention_heads() { return NH; }
