// S2PA attention over the device-resident dict bank, backward (K2).
//
// Replaces the Pallas TPU kernel `s2pa_bank_attend` backward
// (dicttts_tpu/ops/s2pa_bank_pallas.py, `_bwd_call` -> `_bwd_kernel`,
// wired by `_attend_bwd`). The bank is constant in training, so only the
// query gets a gradient. For each word slot n (N = B * Tw):
//   row         = bank[wt[n]]                        [L, E], gathered here
//   logits_l    = row[l, :] . qe[n, :]               f32, -1e9 where km == 0
//   w           = softmax(logits)                    recomputed, f32
//   d_wd_l      = row[l, :] . bank_type(g_ctx[n])    f32
//   d_w_l       = d_wd_l * mask[n, l] + g_w[n, l]
//   d_logits_l  = w_l * (d_w_l - sum_k w_k * d_w_k)  softmax VJP,
//                 0 where km == 0 (the masked logit is a constant)
//   d_qe[n]     = sum_l bank_type(d_logits_l) * row[l, :]
// The two casts to the bank type round like the TPU kernel
// (s2pa_bank_pallas.py:95,100); at f32 they are no-ops. Zeroing the masked
// d_logits changes only all-masked slots (elsewhere w there is exactly 0):
// there w is uniform and does not depend on qe, so d_qe is 0, where the TPU
// kernel returns a nonzero d_qe.
//
// What bounds it on the H100: bytes. Each slot reads one bank row (295 KB
// in f32 at L=96, E=768) for 6*L*E flops. The design reads the row once
// from device memory: one block per slot gathers its own row; phase 1
// streams it with 16-byte loads (one warp per gloss token, lanes along E)
// and computes both dot products, logits and d_wd, from that single read;
// phase 2 runs the masked softmax and its VJP on L floats in shared
// memory; phase 3 re-reads the row, which L2 still holds, for d_qe, each
// thread owning 16 bytes of columns. Nothing of size [N, L, E] is written.

#include <math.h>

#include "s2pa_common.cuh"

namespace {

using namespace s2pa;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One block per word slot. Shared memory: qe row [E] f32, g_ctx row [E]
// f32 (rounded through the bank type), logits -> w [L], d_wd -> d_logits [L].
template <typename T>
__global__ void __launch_bounds__(kThreads)
s2pa_bank_bwd_kernel(const T* __restrict__ bank, const int32_t* __restrict__ wt,
                     const T* __restrict__ qe, const int32_t* __restrict__ km,
                     const float* __restrict__ mask, const T* __restrict__ g_ctx,
                     const float* __restrict__ g_w, T* __restrict__ d_qe, int L, int E) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* g_s = q_s + E;
  float* p_s = g_s + E;
  float* d_s = p_s + L;
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* row = bank + static_cast<size_t>(wt[n]) * L * E;
  const size_t ne = static_cast<size_t>(n) * E;
  const size_t nl = static_cast<size_t>(n) * L;

  for (int e = threadIdx.x; e < E; e += kThreads) {
    q_s[e] = to_float(qe[ne + e]);
    g_s[e] = to_float(g_ctx[ne + e]);
  }
  __syncthreads();

  // phase 1: logits and d_wd from one read of the row
  constexpr int V = Vec16<T>::n;
  for (int l = warp; l < L; l += kWarps) {
    const T* r = row + static_cast<size_t>(l) * E;
    float acc_q = 0.f, acc_g = 0.f;
    for (int e = lane * V; e < E; e += 32 * V) {
      float x[V];
      Vec16<T>::load(r + e, x);
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_s + e + i);
        const float4 g4 = *reinterpret_cast<const float4*>(g_s + e + i);
        acc_q = fmaf(x[i], q4.x, acc_q);
        acc_q = fmaf(x[i + 1], q4.y, acc_q);
        acc_q = fmaf(x[i + 2], q4.z, acc_q);
        acc_q = fmaf(x[i + 3], q4.w, acc_q);
        acc_g = fmaf(x[i], g4.x, acc_g);
        acc_g = fmaf(x[i + 1], g4.y, acc_g);
        acc_g = fmaf(x[i + 2], g4.z, acc_g);
        acc_g = fmaf(x[i + 3], g4.w, acc_g);
      }
    }
    acc_q = warp_sum(acc_q);
    acc_g = warp_sum(acc_g);
    if (lane == 0) {
      p_s[l] = km[nl + l] != 0 ? acc_q : kMaskValue;
      d_s[l] = acc_g;
    }
  }
  __syncthreads();

  // phase 2: softmax and its VJP over L (one warp); d_logits rounded to T
  if (warp == 0) {
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, p_s[l]);
    m = warp_max(m);
    float s = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float ex = expf(p_s[l] - m);
      p_s[l] = ex;
      s += ex;
    }
    s = warp_sum(s);
    float wdw = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float wl = p_s[l] / s;
      const float dw = d_s[l] * mask[nl + l] + g_w[nl + l];
      p_s[l] = wl;
      d_s[l] = dw;
      wdw = fmaf(wl, dw, wdw);
    }
    wdw = warp_sum(wdw);
    for (int l = lane; l < L; l += 32) {
      const float dl = km[nl + l] != 0 ? p_s[l] * (d_s[l] - wdw) : 0.f;
      d_s[l] = to_float(from_float<T>(dl));
    }
  }
  __syncthreads();

  // phase 3: d_qe, each thread owns V consecutive columns (L2 re-read)
  for (int e = threadIdx.x * V; e < E; e += kThreads * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int l = 0; l < L; ++l) {
      float x[V];
      Vec16<T>::load(row + static_cast<size_t>(l) * E + e, x);
      const float dl = d_s[l];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(dl, x[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) d_qe[ne + e + i] = from_float<T>(acc[i]);
  }
}

}  // namespace

// Plain C entry point. Pointers are device pointers of contiguous tensors:
// bank [V, L, E], wt [N] int32, qe [N, E] (bank dtype), km [N, L] int32,
// mask [N, L] f32, g_ctx [N, E] (bank dtype), g_w [N, L] f32 -> d_qe [N, E]
// (bank dtype). E must be a multiple of 8. Returns the cudaError_t of the
// launch.
extern "C" int s2pa_bank_bwd(const void* bank, const void* wt, const void* qe, const void* km,
                             const void* mask, const void* g_ctx, const void* g_w, void* d_qe,
                             int n, int L, int E, int is_bf16, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(2 * E + 2 * L) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    s2pa_bank_bwd_kernel<__nv_bfloat16><<<n, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(bank), static_cast<const int32_t*>(wt),
        static_cast<const __nv_bfloat16*>(qe), static_cast<const int32_t*>(km),
        static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(g_ctx),
        static_cast<const float*>(g_w), static_cast<__nv_bfloat16*>(d_qe), L, E);
  } else {
    s2pa_bank_bwd_kernel<float><<<n, kThreads, smem, s>>>(
        static_cast<const float*>(bank), static_cast<const int32_t*>(wt),
        static_cast<const float*>(qe), static_cast<const int32_t*>(km),
        static_cast<const float*>(mask), static_cast<const float*>(g_ctx),
        static_cast<const float*>(g_w), static_cast<float*>(d_qe), L, E);
  }
  return static_cast<int>(cudaGetLastError());
}
