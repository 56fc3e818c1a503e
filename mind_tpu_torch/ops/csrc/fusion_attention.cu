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
// with node width D, edge width E and NH heads of dh = D / NH, each a
// compile-time constant of the library, and so is its layout
// (fusion_common.cuh): what follows is the resident layout (D, E multiples
// of 16 from 16 to 128, NH <= 16, dh a multiple of 8), which the main path's
// network (D = E = 128, 8 heads) and the narrow test network (32 / 32, 4
// heads) take. Every other shape (above 128, widths that are not multiples
// of 16, any head layout) takes the tiled route of fusion_tiled.cuh: pair
// tiles of 128 pairs on a register-tiled FMA product fed by cp.async stages,
// keys and values folded from a head width of 8; run_f32 picks it at
// compile time.
//
// Folded keys and values. k and v are never formed per pair:
//   logit_h[i,j] = mem[i,j] . (Wk[:, h] q_h[j]) / sqrt(dh)       (+ a term constant in i)
//   out_h[j]     = (sum_i attn_h[i,j] mem[i,j]) Wv[:, h] + bv_h   (the weights sum to 1)
// so a pair costs an [E x D] product (and a [D x E] one with the edge update)
// and two [NH x D] ones instead of four products: at 128 / 128 / 8, 9.5 GFLOP
// per call at B = 8, N = 129 with the edge update (5.2 without) instead of
// 17.7 (13.3). The result differs from the unfolded form only by the order of
// float32 sums.
//
// Bound on the H100 (B = 8, N = 129, 128 / 128 / 8, edge update): 9.5 GFLOP
// at 67 TFLOP/s of non-tensor float32 is 0.142 ms; 137 MB of edge in and out
// at 3.35 TB/s is 0.041 ms. The work is bound by operations, so the design
// keeps the four FMA pipes busy:
//
// - (scene, target) pairs are flattened into B*N columns and a block owns TJ
//   consecutive ones (TJ = 8: 1032 columns are 129 full tiles on 132 SMs, one
//   wave, no tile of padding; a tile may straddle two scenes);
// - Wm_e and We stay resident in shared memory (128 KB at 128 / 128), copied
//   once per block with cp.async;
// - sources stream in chunks of 8, so a chunk is 8 TJ (i, j) rows; the edge
//   chunk of the next step is prefetched with cp.async into the second of two
//   buffers while the current one is worked on;
// - each product is a [8 TJ x K] x [K x W] SIMT GEMM out of shared memory
//   with a TJ x W/16 register tile per thread (128 threads; at 128 wide, 8 x 8:
//   16 16-byte shared-memory loads per 256 FMAs);
// - thread (ty, tx) owns source ty of the chunk, all TJ targets, and W/16
//   columns of a W-wide row (Cols<W>), so LayerNorm statistics are shuffles
//   over 16 lanes;
// - mem overwrites the edge chunk in shared memory; the residual edge + eu
//   reads the edge again from L2;
// - the softmax is online: a thread carries NH D / 16 / (8 / TJ) of the
//   block's [TJ targets x NH heads x D] accumulator in registers (64 at
//   128 / 8); a block takes TJ = 4 targets where NH D > 1024, so that neither
//   the accumulator nor the folded keys [TJ][NH][D] outgrow registers and
//   shared memory;
// - node Wm_s, node Wm_t + bm, q, the folded keys and the output products are
//   per-token work and run once per call in fusion_common.cuh's kernels.
//
// Numerics: plain float32 FMA in every product, no TF32 and no bf16;
// LayerNorm is two-pass as in fused_edge_attention_ref.

#include "fusion_common.cuh"
#include "fusion_tiled.cuh"

namespace {

using namespace fusion;

// The columns of a W-wide row that lane tx (of 16) holds: CW = W / 16 of
// them, in NG groups of V adjacent ones; value c is column
// (c / V) * 16 V + tx V + c % V. At W = 128: 4tx..4tx+3 and 64+4tx..64+4tx+3.
template <int W>
struct Cols {
  static constexpr int CW = W / 16;
  static constexpr int V = CW % 4 == 0 ? 4 : CW % 2 == 0 ? 2 : 1;
  static constexpr int NG = CW / V;
};

// V adjacent floats: shared memory, global memory (read-only path), store.
template <int V> __device__ __forceinline__ void ld_v(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = *p;
  }
}
template <int V> __device__ __forceinline__ void ldg_v(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = __ldg(p);
  }
}
template <int V> __device__ __forceinline__ void st_v(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The lane's columns of a W-wide row: out of global memory, out of shared
// memory, into memory.
template <int W> __device__ __forceinline__ void load_cols(const float* __restrict__ p,
                                                           int tx, float* o) {
  using C = Cols<W>;
#pragma unroll
  for (int g = 0; g < C::NG; ++g) ldg_v<C::V>(p + g * 16 * C::V + tx * C::V, o + g * C::V);
}
template <int W> __device__ __forceinline__ void shared_cols(const float* p, int tx, float* o) {
  using C = Cols<W>;
#pragma unroll
  for (int g = 0; g < C::NG; ++g) ld_v<C::V>(p + g * 16 * C::V + tx * C::V, o + g * C::V);
}
template <int W> __device__ __forceinline__ void store_cols(float* p, int tx, const float* v) {
  using C = Cols<W>;
#pragma unroll
  for (int g = 0; g < C::NG; ++g) st_v<C::V>(p + g * 16 * C::V + tx * C::V, v + g * C::V);
}

// The block's layout for the library's widths.
template <class S>
struct LayoutA {
  static constexpr int D = S::D, E = S::E, NH = S::NH;
  static constexpr int TJ = NH * D > 1024 ? 4 : 8;   // (scene, target) columns a block
  static constexpr int R = TI * TJ;                  // (source, target) rows a chunk
  // the softmax: the 8 / TJ row groups of a target split its heads
  static constexpr int HG = 8 / TJ;                  // head groups
  static constexpr int NHG = NH / HG;                // heads a group, over its 16 lanes
  // lanes a head where they divide 16, else 0: each lane then holds D / 16
  // columns of every head of its group
  static constexpr int LPH = 16 % NHG == 0 ? 16 / NHG : 0;
  static constexpr int NPL = NHG * D / 16;           // accumulator values a lane
  static constexpr int AV = NPL % 4 == 0 ? 4 : NPL % 2 == 0 ? 2 : 1;   // with LPH
  static constexpr int XW = D > E ? D : E;           // a chunk buffer's row
  static constexpr int CWM = (D > E ? D : E) / 16;   // register tile's columns
  // shared-memory layout (floats)
  static constexpr int OFF_WME = 0;                  // [E][D] Wm_e
  static constexpr int OFF_WE = OFF_WME + E * D;     // [D][E] We
  static constexpr int OFF_X0 = OFF_WE + D * E;      // [R][E] edge chunk, then [R][D] mem
  static constexpr int OFF_X1 = OFF_X0 + R * XW;     // the other buffer
  static constexpr int OFF_QK = OFF_X1 + R * XW;     // [TJ][NH][D] folded keys
  static constexpr int OFF_L = OFF_QK + TJ * NH * D; // [R][NH] logits
  static constexpr int SMEM_FLOATS = OFF_L + R * NH;
  static constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);   // 231,424 at 128/128/8
  static_assert(NH % HG == 0, "a block of 4 targets splits its heads in two groups");
  static_assert(NPL <= 64, "the softmax accumulator is at most 64 registers a thread");
  static_assert(SMEM_BYTES <= 232448, "the layout must fit the H100's opt-in shared memory");
};

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[rr][c] = sum_k a[rr][k] w[k][col(c)] for the thread's TJ rows (stride
// K) and the W / 16 columns of Cols<W>; w is [K][W].
template <int K, int W, int TJ, int CWM>
__device__ __forceinline__ void gemm_rows(const float* __restrict__ a,
                                          const float* __restrict__ w, int tx,
                                          float acc[TJ][CWM]) {
  using C = Cols<W>;
#pragma unroll
  for (int rr = 0; rr < TJ; ++rr)
#pragma unroll
    for (int c = 0; c < C::CW; ++c) acc[rr][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[TJ];
#pragma unroll
    for (int rr = 0; rr < TJ; ++rr)
      av[rr] = *reinterpret_cast<const float4*>(a + rr * K + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[C::CW];
      shared_cols<W>(w + (k + kk) * W, tx, wv);
#pragma unroll
      for (int rr = 0; rr < TJ; ++rr) {
        const float x = kk == 0 ? av[rr].x : kk == 1 ? av[rr].y
                      : kk == 2 ? av[rr].z : av[rr].w;
#pragma unroll
        for (int c = 0; c < C::CW; ++c) acc[rr][c] = fmaf(x, wv[c], acc[rr][c]);
      }
    }
  }
}

// Two-pass LayerNorm of one W-wide row held as W / 16 values in each of 16 lanes.
template <int W>
__device__ __forceinline__ void ln_row(float* v, const float* __restrict__ g,
                                       const float* __restrict__ b, int tx) {
  constexpr int CW = Cols<W>::CW;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CW; ++c) s += v[c];
  const float mean = group16_sum(s) * (1.f / W);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CW; ++c) { const float d = v[c] - mean; sq = fmaf(d, d, sq); }
  const float inv = rsqrtf(group16_sum(sq) * (1.f / W) + LN_EPS);
  float gv[CW], bv[CW];
  load_cols<W>(g, tx, gv);
  load_cols<W>(b, tx, bv);
#pragma unroll
  for (int c = 0; c < CW; ++c) v[c] = (v[c] - mean) * inv * gv[c] + bv[c];
}

template <class S>
__global__ void __launch_bounds__(NT, 1)
edge_attention_f32_kernel(const float* __restrict__ edge,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ wm_e, const float* __restrict__ we,
                          const float* __restrict__ sp, const float* __restrict__ tp,
                          const float* __restrict__ qk, Vecs v,
                          float* __restrict__ ctx, float* __restrict__ edge_out,
                          int n, int cols, int update_edge) {
  using L = LayoutA<S>;
  constexpr int D = S::D, E = S::E, NH = S::NH, TJ = L::TJ, R = L::R, CWM = L::CWM;
  constexpr int NHG = L::NHG, LPH = L::LPH, NPL = L::NPL, AV = L::AV;
  constexpr int NRUN = LPH > 0 ? 1 : NHG;   // softmax states a thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Wme = smem + L::OFF_WME;
  float* We = smem + L::OFF_WE;
  float* QK = smem + L::OFF_QK;
  float* Ls = smem + L::OFF_L;
  __shared__ long long s_base[TJ];   // element offset of edge[b, 0, j, 0]
  __shared__ int s_tok0[TJ];         // b * n, or -1 for a column past the end

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * TJ;

  if (tid < TJ) {
    const int c = c0 + tid;
    const int b = c / n, j = c % n;
    s_base[tid] = ((long long)b * n * n + j) * E;
    s_tok0[tid] = c < cols ? b * n : -1;
  }
  // resident weights and this tile's folded keys; every block copies the
  // same weights, so each starts at another row and they do not queue on one
  // L2 line
  for (int it = tid; it < E * D / 4; it += NT) {
    const int idx = (unsigned)(it + blockIdx.x * (D / 4)) % (unsigned)(E * D / 4);
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
    for (int idx = tid; idx < R * E / 4; idx += NT) {
      const int r = idx / (E / 4), p = idx % (E / 4);
      const int i = i0 + r / TJ, rr = r % TJ;
      const bool ok = i < n && s_tok0[rr] >= 0;
      const float* src = edge + s_base[rr] + (long long)i * n * E + p * 4;
      cp_async16(buf + r * E + p * 4, ok ? src : edge, ok);
    }
    cp_async_commit();
  };

  // online-softmax state: the thread owns target st and, of head group hg,
  // either head sm_h and its NPL columns sm_part * AV + q * AV * LPH + (0..AV-1)
  // (LPH > 0; at 128 / 8: head tx / 2, 64 columns), or D / 16 columns
  // x * 16 + tx of each of the group's NHG heads (LPH == 0)
  const int st = ty % TJ, hg = ty / TJ;
  const int sm_h = hg * NHG + (LPH > 0 ? tx / (LPH > 0 ? LPH : 1) : 0);
  const int sm_part = LPH > 0 ? tx % (LPH > 0 ? LPH : 1) : 0;
  float run_max[NRUN], run_sum[NRUN];
#pragma unroll
  for (int x = 0; x < NRUN; ++x) { run_max[x] = -INFINITY; run_sum[x] = 0.f; }
  float cacc[NPL];
#pragma unroll
  for (int x = 0; x < NPL; ++x) cacc[x] = 0.f;

  float acc[TJ][CWM];
  const int n_chunks = (n + TI - 1) / TI;
  load_chunk(smem + L::OFF_X0, 0);

  for (int ch = 0; ch < n_chunks; ++ch) {
    float* X = smem + ((ch & 1) ? L::OFF_X1 : L::OFF_X0);
    const int i0 = ch * TI;
    if (ch + 1 < n_chunks) {
      load_chunk(smem + ((ch & 1) ? L::OFF_X0 : L::OFF_X1), i0 + TI);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int i = i0 + ty;            // the thread's source
    const bool i_ok = i < n;

    // ---- mem = relu(LN(edge Wm_e + node_i Wm_s + node_j Wm_t + bm)) ----
    gemm_rows<E, D, TJ, CWM>(X + ty * TJ * E, Wme, tx, acc);
#pragma unroll
    for (int rr = 0; rr < TJ; ++rr) {
      const int tok0 = s_tok0[rr];
      if (i_ok && tok0 >= 0) {
        float a[Cols<D>::CW], t[Cols<D>::CW];
        load_cols<D>(sp + (size_t)(tok0 + i) * D, tx, a);
        load_cols<D>(tp + (size_t)(c0 + rr) * D, tx, t);
#pragma unroll
        for (int c = 0; c < Cols<D>::CW; ++c) acc[rr][c] += a[c] + t[c];
      }
      ln_row<D>(acc[rr], v.ln_m_g, v.ln_m_b, tx);
#pragma unroll
      for (int c = 0; c < Cols<D>::CW; ++c) acc[rr][c] = fmaxf(acc[rr][c], 0.f);
    }
    __syncthreads();   // every thread has read its edge rows: X becomes mem

    // ---- mem -> shared memory; logits mem . qk[j][h] ----
#pragma unroll
    for (int rr = 0; rr < TJ; ++rr) {
      store_cols<D>(X + (ty * TJ + rr) * D, tx, acc[rr]);
      float part[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float qv[Cols<D>::CW];
        shared_cols<D>(QK + (rr * NH + h) * D, tx, qv);
        float s = acc[rr][0] * qv[0];
#pragma unroll
        for (int c = 1; c < Cols<D>::CW; ++c) s = fmaf(acc[rr][c], qv[c], s);
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
      constexpr int CE = Cols<E>::CW;
      gemm_rows<D, E, TJ, CWM>(X + ty * TJ * D, We, tx, acc);
      float be[CE];
      load_cols<E>(v.be, tx, be);
#pragma unroll
      for (int rr = 0; rr < TJ; ++rr) {
        // every lane runs the LayerNorm shuffles; only loads and stores are
        // guarded for rows past the end
        const bool ok = i_ok && s_tok0[rr] >= 0;
#pragma unroll
        for (int c = 0; c < CE; ++c) acc[rr][c] += be[c];
        ln_row<E>(acc[rr], v.ln_e1_g, v.ln_e1_b, tx);
        const size_t off = ok ? (size_t)(s_base[rr] + (long long)i * n * E) : 0;
        float e[CE];
        load_cols<E>(edge + off, tx, e);
#pragma unroll
        for (int c = 0; c < CE; ++c) acc[rr][c] = fmaxf(acc[rr][c], 0.f) + e[c];
        ln_row<E>(acc[rr], v.ln_e2_g, v.ln_e2_b, tx);
        if (ok) store_cols<E>(edge_out + off, tx, acc[rr]);
      }
    }

    // ---- online softmax over this chunk's sources, accumulating mem rows ----
    {
      const int ns = min(TI, n - i0);
      if constexpr (LPH > 0) {
        float l[TI];
        float mx = run_max[0];
#pragma unroll
        for (int s = 0; s < TI; ++s) {
          l[s] = s < ns ? Ls[(s * TJ + st) * NH + sm_h] : -INFINITY;
          mx = fmaxf(mx, l[s]);
        }
        const float corr = expf(run_max[0] - mx);
        run_sum[0] *= corr;
#pragma unroll
        for (int x = 0; x < NPL; ++x) cacc[x] *= corr;
#pragma unroll
        for (int s = 0; s < TI; ++s) {
          if (s < ns) {
            const float p = expf(l[s] - mx);
            run_sum[0] += p;
            const float* row = X + (s * TJ + st) * D + sm_part * AV;
#pragma unroll
            for (int q = 0; q < NPL / AV; ++q) {
              float m[AV];
              ld_v<AV>(row + q * AV * LPH, m);
#pragma unroll
              for (int u = 0; u < AV; ++u) cacc[q * AV + u] = fmaf(p, m[u], cacc[q * AV + u]);
            }
          }
        }
        run_max[0] = mx;
      } else {
        constexpr int NPH = D / 16;   // values a lane of each head
#pragma unroll
        for (int lh = 0; lh < NHG; ++lh) {
          const int h = hg * NHG + lh;
          float l[TI];
          float mx = run_max[lh];
#pragma unroll
          for (int s = 0; s < TI; ++s) {
            l[s] = s < ns ? Ls[(s * TJ + st) * NH + h] : -INFINITY;
            mx = fmaxf(mx, l[s]);
          }
          const float corr = expf(run_max[lh] - mx);
          run_sum[lh] *= corr;
#pragma unroll
          for (int x = 0; x < NPH; ++x) cacc[lh * NPH + x] *= corr;
#pragma unroll
          for (int s = 0; s < TI; ++s) {
            if (s < ns) {
              const float p = expf(l[s] - mx);
              run_sum[lh] += p;
              const float* row = X + (s * TJ + st) * D + tx;
#pragma unroll
              for (int x = 0; x < NPH; ++x)
                cacc[lh * NPH + x] = fmaf(p, row[x * 16], cacc[lh * NPH + x]);
            }
          }
          run_max[lh] = mx;
        }
      }
    }
    __syncthreads();   // X is free for the prefetch of chunk ch + 2
  }

  // ---- ctx[c][h][:] = softmax-weighted sum of mem rows, normalised ----
  if (s_tok0[st] >= 0) {
    if constexpr (LPH > 0) {
      const float inv = 1.f / run_sum[0];
      float* dst = ctx + ((size_t)(c0 + st) * NH + sm_h) * D + sm_part * AV;
#pragma unroll
      for (int q = 0; q < NPL / AV; ++q) {
        float o[AV];
#pragma unroll
        for (int u = 0; u < AV; ++u) o[u] = cacc[q * AV + u] * inv;
        st_v<AV>(dst + q * AV * LPH, o);
      }
    } else {
      constexpr int NPH = D / 16;
#pragma unroll
      for (int lh = 0; lh < NHG; ++lh) {
        const float inv = 1.f / run_sum[lh];
        float* dst = ctx + ((size_t)(c0 + st) * NH + hg * NHG + lh) * D + tx;
#pragma unroll
        for (int x = 0; x < NPH; ++x) dst[x * 16] = cacc[lh * NPH + x] * inv;
      }
    }
  }
}

// One call at the library's widths S: prologue + main + epilogue on `s`.
template <class S>
int run_f32(const float* node, const float* edge, const unsigned char* mask,
            const float* wm_e, const float* wm_s, const float* wm_t, const float* wq,
            const float* wk, const float* wv, const float* wo, const float* we, const Vecs& v,
            float* sp, float* tp, float* qk, float* ctx, float* out, float* edge_out,
            unsigned char* scratch, int batch, int n, int update_edge, cudaStream_t s) {
  const int cols = batch * n;
  constexpr int CBZ = token_col_blocks<S>();
  if constexpr (S::RESIDENT) {
    using L = LayoutA<S>;
    if ((int)L::SMEM_BYTES > smem_optin()) return ERR_SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        edge_attention_f32_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    constexpr int TR = TOK, TK = out_tokens<S, true>();
    token_proj_kernel<S, float, float, true><<<dim3((cols + TR - 1) / TR, 3, CBZ), NT, 0, s>>>(
        node, wm_s, wm_t, wq, wk, v, sp, tp, qk, cols);
    edge_attention_f32_kernel<S><<<(cols + L::TJ - 1) / L::TJ, NT, L::SMEM_BYTES, s>>>(
        edge, mask, wm_e, we, sp, tp, qk, v, ctx, edge_out, n, cols, update_edge);
    out_proj_kernel<S, float, true><<<dim3((cols + TK - 1) / TK, 1, CBZ), NT, 0, s>>>(
        ctx, wv, wo, v, out, cols);
  } else {
    // tiled: qk and ctx are [B*N, NH, D] where the route folds (qt, then the
    // per-head weighted memory; q waits in ctx and the attention sum in sp),
    // else [B*N, D] (q, then the attention sum)
    using L = tiled::Layout<S, float>;
    if (L::SMEM_BYTES > smem_optin()) return ERR_SMEM;
    float* q = L::FOLD ? ctx : qk;
    tiled::token_proj<S>(node, wm_s, wm_t, wq, v, sp, tp, q, cols, s);
    if constexpr (L::FOLD) tiled::fold_keys<S>(q, wk, qk, cols, s);
    const int err = tiled::run_pairs<S, float, float>(edge, mask, wm_e, we, wk, wv, sp, tp, qk, v,
                                                      ctx, edge_out, scratch, batch, n,
                                                      update_edge, 0, s);
    if (err != 0) return err;
    float* attn = ctx;
    if constexpr (L::FOLD) {
      tiled::fold_values<S>(ctx, wv, sp, cols, s);
      attn = sp;
    }
    tiled::out_proj<S>(attn, wo, v, out, cols, s);
  }
  return (int)cudaGetLastError();
}

// {the largest dynamic shared memory of a kernel, 0 resident / 1 tiled,
// columns a block (resident; 0 tiled), fold, tile rows, tile columns,
// stages, epilogue LayerNorms (1 memory, 2 edge), scratch bytes a pair (S,
// M, L)}: 11 values
template <class S>
void layout_of(int* out) {
  if constexpr (S::RESIDENT) {
    const int v[11] = {(int)LayoutA<S>::SMEM_BYTES, 0, LayoutA<S>::TJ, 1, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < 11; ++k) out[k] = v[k];
  } else {
    using L = tiled::Layout<S, float>;
    const int v[11] = {L::SMEM_BYTES, 1, 0, L::FOLD ? 1 : 0, tiled::BM, L::BN, L::STAGES,
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
  if constexpr (S::RESIDENT) {
    fns[k++] = (const void*)token_proj_kernel<S, float, float, true>;
    fns[k++] = (const void*)edge_attention_f32_kernel<S>;
    fns[k++] = (const void*)out_proj_kernel<S, float, true>;
  } else {
    using namespace tiled;
    using L = Layout<S, float>;
    constexpr int D = S::D, E = S::E, LDS = L::LDS, LDM = L::LDM;
    constexpr int BD = L::BN_D, BE = L::BN_E;
    fns[k++] = (const void*)token_product<TokenProj<S>>;
    if constexpr (L::FOLD) fns[k++] = (const void*)token_product<FoldKeys<S>>;
    fns[k++] = (const void*)product_f32<E, D, BD, E % 4 == 0,
                                        L::EPI_MEM_LN ? EPI_MEM : EPI_STORE, LDM, float>;
    if constexpr (!L::EPI_MEM_LN) fns[k++] = (const void*)mem_pass<S, float, LDS, LDM>;
    fns[k++] = (const void*)product_f32<D, E, BE, true, L::EPI_EDGE_LN ? EPI_EDGE : EPI_STORE,
                                        LDM, float>;
    if constexpr (!L::EPI_EDGE_LN) fns[k++] = (const void*)edge_pass<S, float, float, LDS>;
    if constexpr (L::FOLD) {
      fns[k++] = (const void*)token_product<LogitsFold<S, LDM>>;
      fns[k++] = (const void*)softmax_stats<S::NH>;
      fns[k++] = (const void*)token_product<ContextFold<S, LDM>>;
      fns[k++] = (const void*)token_product<FoldValues<S>>;
    } else {
      if constexpr (L::EPI_LOGITS_OK) {
        fns[k++] = (const void*)product_f32<D, D, BD, true, EPI_LOGITS, LDM, float, S::DH>;
        fns[k++] = (const void*)product_f32<D, D, BD, true, EPI_STORE, LDM, float>;
      } else {
        fns[k++] = (const void*)product_f32<D, D, BD, true, EPI_STORE, LDM, float>;
        fns[k++] = (const void*)logits_pass<S, LDS>;
      }
      fns[k++] = (const void*)softmax_stats<S::NH>;
      fns[k++] = (const void*)attn_pass<S, LDS>;
    }
    fns[k++] = (const void*)token_product<OutProj<S>>;
  }
  return k;
}

// Each kernel of the library: {static shared memory, local memory,
// registers} from cudaFuncGetAttributes, in kernels_of's order. Returns the
// count of kernels, or minus a CUDA error.
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
// (Shape). sp and tp [B*N, D] are float32 scratch from the caller, and so are
// qk and ctx: [B*N, NH, D] each where the route folds (the resident layout,
// and the tiled route from a head width of 8: folded keys and per-head
// weighted memory), [B*N, D] each otherwise (q and the attention sum).
// `scratch` holds the tiled route's pair scratch
// (tiled::pair_scratch_bytes(B*N*N); null in the resident layout). Returns
// 0, a CUDA error, ERR_SMEM (before any launch) where the layout does not
// fit the current device's opt-in shared memory, or tiled::ERR_TMA (before
// the pair steps' launches) where a tensor map cannot be encoded.
extern "C" int fused_edge_attention_f32(
    const float* node, const float* edge, const unsigned char* mask,
    const float* wm_e, const float* wm_s, const float* wm_t, const float* bm,
    const float* ln_m_g, const float* ln_m_b, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, const float* we, const float* be,
    const float* ln_e1_g, const float* ln_e1_b, const float* ln_e2_g,
    const float* ln_e2_b, float* sp, float* tp, float* qk, float* ctx,
    float* out, float* edge_out, void* scratch, int batch, int n, int update_edge,
    void* stream) {
  const fusion::Vecs v{bm, ln_m_g, ln_m_b, bq, bk, bv, bo, be,
                       ln_e1_g, ln_e1_b, ln_e2_g, ln_e2_b};
  return run_f32<fusion::Shape>(node, edge, mask, wm_e, wm_s, wm_t, wq, wk, wv, wo, we, v, sp,
                                tp, qk, ctx, out, edge_out, (unsigned char*)scratch, batch, n,
                                update_edge, (cudaStream_t)stream);
}

// The widths this library was built for and its layout: {D, E, NH,
// layout_of's 11 values}; the loader checks them against the shape it asked
// for and against the layout's mirror (fusion_attention.py::kernel_smem).
extern "C" void fused_edge_attention_shape(int* out) {
  out[0] = fusion::Shape::D;
  out[1] = fusion::Shape::E;
  out[2] = fusion::Shape::NH;
  layout_of<fusion::Shape>(out + 3);
}

// {static shared memory, local memory, registers} of each of the library's
// kernels (kernels_of) into out[3 k .. 3 k + 2]; their count, or minus a
// CUDA error.
extern "C" int fused_edge_attention_attrs(int* out) { return attrs_of<fusion::Shape>(out); }

template <class S>
long long scratch_of(long long pairs, long long tokens) {
  if constexpr (S::RESIDENT) return 0;
  else return (long long)fusion::tiled::pair_scratch_bytes<fusion::tiled::Layout<S, float>>(pairs, tokens);
}

// The tiled route's pair scratch of a call over `batch` scenes of `n`
// nodes, in bytes (0 in the resident layout).
extern "C" long long fused_edge_attention_scratch(long long batch, long long n) {
  return scratch_of<fusion::Shape>(batch * n * n, batch * n);
}

template <class S>
int product_entry(int which, const void* a, long long lda, const void* w, float* c,
                  long long ldc, long long rows, void* stream) {
  if constexpr (S::RESIDENT) {
    return -3;
  } else {
    const int err = fusion::tiled::product_alone<S, float>(
        which, (const float*)a, lda, (const float*)w, c, ldc, rows, (cudaStream_t)stream);
    return err != 0 ? err : (int)cudaGetLastError();
  }
}

// One of the tiled route's products alone (tiled::product_alone), on
// `stream`: 0, a CUDA error, tiled::ERR_TMA, or -3 in the resident layout,
// which has no such product.
extern "C" int fused_edge_attention_product(int which, const void* a, long long lda, const void* w, float* c,
                                long long ldc, long long rows, void* stream) {
  return product_entry<fusion::Shape>(which, a, lda, w, c, ldc, rows, stream);
}
