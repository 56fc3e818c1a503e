// Fused edge-conditioned fusion-layer core for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel mind_tpu/ops/fusion_attention.py::_kernel (the
// Pallas kernel launched by fused_edge_attention) in its float32 mode. Per
// scene b, source i and target j:
//
//   mem[i,j]   = relu(LN(edge[i,j] Wm_e + node[i] Wm_s + node[j] Wm_t + bm))
//   edge'[i,j] = LN(edge[i,j] + relu(LN(mem[i,j] We + be)))   (update_edge)
//   q[j] = node[j] Wq + bq,  k/v[i,j] = mem[i,j] Wk/Wv + bk/bv
//   out[j] = softmax_i(q[j].k[i,j] / sqrt(dh), masked keys -> -1e9) v  Wo + bo
//
// with 8 heads of dh = 16 and D = E = 128.
//
// Folded keys and values. k and v are never formed per pair:
//   logit_h[i,j] = mem[i,j] . (Wk[:, h] q_h[j]) / sqrt(dh)       (+ a term constant in i)
//   out_h[j]     = (sum_i attn_h[i,j] mem[i,j]) Wv[:, h] + bv_h   (the weights sum to 1)
// so a pair costs two 128x128 products (one without the edge update) and two
// [8 x 128] ones instead of four 128x128 products: 9.5 GFLOP per call at
// B = 8, N = 129 with the edge update (5.2 without) instead of 17.7 (13.3).
// The result differs from the unfolded form only by the order of float32 sums.
//
// Bound on the H100 (B = 8, N = 129, edge update): 9.5 GFLOP at 67 TFLOP/s of
// non-tensor float32 is 0.142 ms; 137 MB of edge in and out at 3.35 TB/s is
// 0.041 ms. The work is bound by operations, so the design keeps the four FMA
// pipes busy:
//
// - (scene, target) pairs are flattened into B*N columns and a block owns 8
//   consecutive ones: 1032 columns are 129 full tiles on 132 SMs, one wave,
//   no tile of padding; a tile may straddle two scenes;
// - Wm_e and We stay resident in shared memory (128 KB), copied once per
//   block with cp.async;
// - sources stream in chunks of 8, so a chunk is 64 (i, j) rows; the edge
//   chunk of the next step is prefetched with cp.async into the second of two
//   buffers while the current one is worked on;
// - each product is a [64 x 128] x [128 x 128] SIMT GEMM out of shared memory
//   with an 8 x 8 register tile per thread (128 threads): 16 16-byte
//   shared-memory loads per 256 FMAs;
// - thread (ty, tx) owns source ty of the chunk, all 8 targets, and columns
//   4tx..4tx+3 and 64+4tx..64+4tx+3, so LayerNorm statistics are shuffles
//   over 16 lanes;
// - mem overwrites the edge chunk in shared memory; the residual edge + eu
//   reads the edge again from L2;
// - the softmax is online: a thread carries 64 of the block's
//   [8 targets x 8 heads x 128] accumulator in registers;
// - node Wm_s, node Wm_t + bm, q, the folded keys and the output products are
//   per-token work and run once per call in fusion_common.cuh's kernels.
//
// Numerics: plain float32 FMA in every product, no TF32 and no bf16;
// LayerNorm is two-pass as in fused_edge_attention_ref.

#include "fusion_common.cuh"

namespace {

using namespace fusion;

// shared-memory layout (floats)
constexpr int OFF_WME = 0;                    // [128][128] Wm_e
constexpr int OFF_WE = OFF_WME + D * D;       // [128][128] We
constexpr int OFF_X0 = OFF_WE + D * D;        // [R][128] edge chunk, then mem
constexpr int OFF_X1 = OFF_X0 + R * D;        // [R][128] the other buffer
constexpr int OFF_QK = OFF_X1 + R * D;        // [TJ][NH][128] folded keys
constexpr int OFF_L = OFF_QK + TJ * NH * D;   // [R][NH] logits
constexpr int SMEM_FLOATS = OFF_L + R * NH;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);   // 231,424

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[rr][c] = sum_k a[rr][k] w[k][col(c)] for the thread's 8 rows and 8 columns.
__device__ __forceinline__ void gemm_8x8(const float* __restrict__ a,
                                         const float* __restrict__ w, int tx,
                                         float acc[8][8]) {
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[rr][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 av[8];
#pragma unroll
    for (int rr = 0; rr < 8; ++rr)
      av[rr] = *reinterpret_cast<const float4*>(a + rr * D + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(w + (k + kk) * D + tx * 4);
      const float4 w1 = *reinterpret_cast<const float4*>(w + (k + kk) * D + 64 + tx * 4);
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float x = kk == 0 ? av[rr].x : kk == 1 ? av[rr].y
                      : kk == 2 ? av[rr].z : av[rr].w;
        acc[rr][0] = fmaf(x, w0.x, acc[rr][0]);
        acc[rr][1] = fmaf(x, w0.y, acc[rr][1]);
        acc[rr][2] = fmaf(x, w0.z, acc[rr][2]);
        acc[rr][3] = fmaf(x, w0.w, acc[rr][3]);
        acc[rr][4] = fmaf(x, w1.x, acc[rr][4]);
        acc[rr][5] = fmaf(x, w1.y, acc[rr][5]);
        acc[rr][6] = fmaf(x, w1.z, acc[rr][6]);
        acc[rr][7] = fmaf(x, w1.w, acc[rr][7]);
      }
    }
  }
}

// The thread's 8 values of a 128-wide vector in global memory.
__device__ __forceinline__ void load8(const float* __restrict__ p, int tx, float o[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p + tx * 4));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 64 + tx * 4));
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// Two-pass LayerNorm of one 128-wide row held as 8 values in each of 16 lanes.
__device__ __forceinline__ void ln_row(float v[8], const float* __restrict__ g,
                                       const float* __restrict__ b, int tx) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) s += v[c];
  const float mean = group16_sum(s) * (1.f / D);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) { const float d = v[c] - mean; sq = fmaf(d, d, sq); }
  const float inv = rsqrtf(group16_sum(sq) * (1.f / D) + LN_EPS);
  float gv[8], bv[8];
  load8(g, tx, gv);
  load8(b, tx, bv);
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = (v[c] - mean) * inv * gv[c] + bv[c];
}

__global__ void __launch_bounds__(NT, 1)
edge_attention_f32_kernel(const float* __restrict__ edge,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ wm_e, const float* __restrict__ we,
                          const float* __restrict__ sp, const float* __restrict__ tp,
                          const float* __restrict__ qk, Vecs v,
                          float* __restrict__ ctx, float* __restrict__ edge_out,
                          int n, int cols, int update_edge) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Wme = smem + OFF_WME;
  float* We = smem + OFF_WE;
  float* QK = smem + OFF_QK;
  float* Ls = smem + OFF_L;
  __shared__ long long s_base[TJ];   // element offset of edge[b, 0, j, 0]
  __shared__ int s_tok0[TJ];         // b * n, or -1 for a column past the end

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * TJ;

  if (tid < TJ) {
    const int c = c0 + tid;
    const int b = c / n, j = c % n;
    s_base[tid] = ((long long)b * n * n + j) * D;
    s_tok0[tid] = c < cols ? b * n : -1;
  }
  // resident weights and this tile's folded keys; every block copies the
  // same weights, so each starts at another row and they do not queue on one
  // L2 line
  for (int it = tid; it < D * D / 4; it += NT) {
    const int idx = (it + blockIdx.x * (D / 4)) & (D * D / 4 - 1);
    cp_async16(Wme + idx * 4, wm_e + idx * 4, true);
    if (update_edge) cp_async16(We + idx * 4, we + idx * 4, true);
  }
  for (int idx = tid; idx < TJ * NH * D / 4; idx += NT) {
    const bool ok = c0 + idx / (NH * D / 4) < cols;
    cp_async16(QK + idx * 4, ok ? qk + (size_t)c0 * NH * D + idx * 4 : qk, ok);
  }
  __syncthreads();   // s_base, s_tok0

  auto load_chunk = [&](float* buf, int i0) {
#pragma unroll 4
    for (int idx = tid; idx < R * D / 4; idx += NT) {
      const int r = idx / (D / 4), p = idx % (D / 4);
      const int i = i0 + r / TJ, rr = r % TJ;
      const bool ok = i < n && s_tok0[rr] >= 0;
      const float* src = edge + s_base[rr] + (long long)i * n * D + p * 4;
      cp_async16(buf + r * D + p * 4, ok ? src : edge, ok);
    }
    cp_async_commit();
  };

  // online-softmax state: the thread owns target jj = ty, head sm_h and the
  // 64 columns 8q + 4 sm_half .. + 3 (q = 0..15) of that head's accumulator
  const int sm_h = tx >> 1, sm_half = tx & 1;
  float run_max = -INFINITY, run_sum = 0.f;
  float cacc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) cacc[x] = 0.f;

  float acc[8][8];
  const int n_chunks = (n + TI - 1) / TI;
  load_chunk(smem + OFF_X0, 0);

  for (int ch = 0; ch < n_chunks; ++ch) {
    float* X = smem + ((ch & 1) ? OFF_X1 : OFF_X0);
    const int i0 = ch * TI;
    if (ch + 1 < n_chunks) {
      load_chunk(smem + ((ch & 1) ? OFF_X0 : OFF_X1), i0 + TI);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int i = i0 + ty;            // the thread's source
    const bool i_ok = i < n;

    // ---- mem = relu(LN(edge Wm_e + node_i Wm_s + node_j Wm_t + bm)) ----
    gemm_8x8(X + ty * TJ * D, Wme, tx, acc);
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int tok0 = s_tok0[rr];
      if (i_ok && tok0 >= 0) {
        float a[8], t[8];
        load8(sp + (size_t)(tok0 + i) * D, tx, a);
        load8(tp + (size_t)(c0 + rr) * D, tx, t);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[rr][c] += a[c] + t[c];
      }
      ln_row(acc[rr], v.ln_m_g, v.ln_m_b, tx);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[rr][c] = fmaxf(acc[rr][c], 0.f);
    }
    __syncthreads();   // every thread has read its edge rows: X becomes mem

    // ---- mem -> shared memory; logits mem . qk[j][h] ----
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      float* row = X + (ty * TJ + rr) * D;
      *reinterpret_cast<float4*>(row + tx * 4) =
          make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
      *reinterpret_cast<float4*>(row + 64 + tx * 4) =
          make_float4(acc[rr][4], acc[rr][5], acc[rr][6], acc[rr][7]);
      float part[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float* qrow = QK + (rr * NH + h) * D;
        const float4 q0 = *reinterpret_cast<const float4*>(qrow + tx * 4);
        const float4 q1 = *reinterpret_cast<const float4*>(qrow + 64 + tx * 4);
        float s = acc[rr][0] * q0.x;
        s = fmaf(acc[rr][1], q0.y, s);
        s = fmaf(acc[rr][2], q0.z, s);
        s = fmaf(acc[rr][3], q0.w, s);
        s = fmaf(acc[rr][4], q1.x, s);
        s = fmaf(acc[rr][5], q1.y, s);
        s = fmaf(acc[rr][6], q1.z, s);
        s = fmaf(acc[rr][7], q1.w, s);
        part[h] = group16_sum(s);
      }
      if (tx < NH) {
        float mine = part[0];
#pragma unroll
        for (int h = 1; h < NH; ++h) mine = tx == h ? part[h] : mine;
        const int tok0 = s_tok0[rr];
        const bool key_on = i_ok && tok0 >= 0 && mask[tok0 + i];
        Ls[(ty * TJ + rr) * NH + tx] = key_on ? mine : MASKED;
      }
    }
    __syncthreads();   // mem and logits visible

    // ---- edge' = LN(edge + relu(LN(mem We + be))) ----
    if (update_edge) {
      gemm_8x8(X + ty * TJ * D, We, tx, acc);
      float be[8];
      load8(v.be, tx, be);
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        // every lane runs the LayerNorm shuffles; only loads and stores are
        // guarded for rows past the end
        const bool ok = i_ok && s_tok0[rr] >= 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[rr][c] += be[c];
        ln_row(acc[rr], v.ln_e1_g, v.ln_e1_b, tx);
        const size_t off = ok ? (size_t)(s_base[rr] + (long long)i * n * D) : 0;
        float e[8];
        load8(edge + off, tx, e);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[rr][c] = fmaxf(acc[rr][c], 0.f) + e[c];
        ln_row(acc[rr], v.ln_e2_g, v.ln_e2_b, tx);
        if (ok) {
          float* dst = edge_out + off;
          *reinterpret_cast<float4*>(dst + tx * 4) =
              make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
          *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
              make_float4(acc[rr][4], acc[rr][5], acc[rr][6], acc[rr][7]);
        }
      }
    }

    // ---- online softmax over this chunk's sources, accumulating mem rows ----
    {
      const int ns = min(TI, n - i0);
      float l[TI];
      float mx = run_max;
#pragma unroll
      for (int s = 0; s < TI; ++s) {
        l[s] = s < ns ? Ls[(s * TJ + ty) * NH + sm_h] : -INFINITY;
        mx = fmaxf(mx, l[s]);
      }
      const float corr = expf(run_max - mx);
      run_sum *= corr;
#pragma unroll
      for (int x = 0; x < 64; ++x) cacc[x] *= corr;
#pragma unroll
      for (int s = 0; s < TI; ++s) {
        if (s < ns) {
          const float p = expf(l[s] - mx);
          run_sum += p;
          const float* row = X + (s * TJ + ty) * D + sm_half * 4;
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const float4 m = *reinterpret_cast<const float4*>(row + q * 8);
            cacc[q * 4 + 0] = fmaf(p, m.x, cacc[q * 4 + 0]);
            cacc[q * 4 + 1] = fmaf(p, m.y, cacc[q * 4 + 1]);
            cacc[q * 4 + 2] = fmaf(p, m.z, cacc[q * 4 + 2]);
            cacc[q * 4 + 3] = fmaf(p, m.w, cacc[q * 4 + 3]);
          }
        }
      }
      run_max = mx;
    }
    __syncthreads();   // X is free for the prefetch of chunk ch + 2
  }

  // ---- ctx[c][h][:] = softmax-weighted sum of mem rows, normalised ----
  if (s_tok0[ty] >= 0) {
    const float inv = 1.f / run_sum;
    float* dst = ctx + ((size_t)(c0 + ty) * NH + sm_h) * D + sm_half * 4;
#pragma unroll
    for (int q = 0; q < 16; ++q)
      *reinterpret_cast<float4*>(dst + q * 8) =
          make_float4(cacc[q * 4] * inv, cacc[q * 4 + 1] * inv, cacc[q * 4 + 2] * inv,
                      cacc[q * 4 + 3] * inv);
  }
}

}  // namespace

// One call = prologue + main + epilogue on `stream`. sp, tp [B*N, 128],
// qk and ctx [B*N, 8, 128] are float32 scratch from the caller.
extern "C" int fused_edge_attention_f32(
    const float* node, const float* edge, const unsigned char* mask,
    const float* wm_e, const float* wm_s, const float* wm_t, const float* bm,
    const float* ln_m_g, const float* ln_m_b, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, const float* we, const float* be,
    const float* ln_e1_g, const float* ln_e1_b, const float* ln_e2_g,
    const float* ln_e2_b, float* sp, float* tp, float* qk, float* ctx,
    float* out, float* edge_out, int batch, int n, int update_edge, void* stream) {
  using namespace fusion;
  cudaError_t err = cudaFuncSetAttribute(
      edge_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const Vecs v{bm, ln_m_g, ln_m_b, bq, bk, bv, bo, be, ln_e1_g, ln_e1_b, ln_e2_g, ln_e2_b};
  const int cols = batch * n;
  const int tok_blocks = (cols + TOK - 1) / TOK;
  cudaStream_t s = (cudaStream_t)stream;
  token_proj_kernel<float, float, true><<<dim3(tok_blocks, 3), NT, 0, s>>>(
      node, wm_s, wm_t, wq, wk, v, sp, tp, qk, cols);
  edge_attention_f32_kernel<<<(cols + TJ - 1) / TJ, NT, SMEM_BYTES, s>>>(
      edge, mask, wm_e, we, sp, tp, qk, v, ctx, edge_out, n, cols, update_edge);
  out_proj_kernel<float, true><<<tok_blocks, NT, 0, s>>>(ctx, wv, wo, v, out, cols);
  return (int)cudaGetLastError();
}

extern "C" int fused_edge_attention_width() { return fusion::D; }
extern "C" int fused_edge_attention_heads() { return fusion::NH; }
