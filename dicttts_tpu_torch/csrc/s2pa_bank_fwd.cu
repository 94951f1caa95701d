// S2PA attention over the device-resident dict bank, forward (K1).
//
// Replaces the Pallas TPU kernel `s2pa_bank_attend` forward
// (dicttts_tpu/ops/s2pa_bank_pallas.py, `_fwd_call` -> `_fwd_kernel`).
// For each word slot n (N = B * Tw):
//   row      = bank[wt[n]]                         [L, E], gathered here
//   logits_l = row[l, :] . qe[n, :]                f32 accumulation
//   logits_l = -1e9 where km[n, l] == 0            finite mask: an all-masked
//                                                  row gives uniform weights
//   w        = softmax(logits)                     f32, written out (pre-dropout)
//   wd       = bank_type(w * mask[n])              rounded like the TPU kernel
//   ctx[n]   = sum_l wd[l] * row[l, :]             f32 accumulation, stored
//                                                  in the bank type
//
// What bounds it on the H100: bytes. At serving geometry (L=96, E=768,
// bf16) each slot reads a 147 KB bank row and does 4*L*E flops on it, far
// below the card's ~295 flops per byte, so the floor is the row traffic
// over 3.35 TB/s. The design reads each row once from device memory: one
// block per slot gathers its own row (the word id is loaded by the block,
// no prefetch), phase 1 streams it with 16-byte loads (one warp per gloss
// token, lanes along E), and phase 3 re-reads the same 147 KB from L2,
// which holds it, instead of device memory. The [B, Tw, L, E] gathered copy
// that the plain version builds is never materialised.

#include <math.h>

#include "s2pa_common.cuh"

namespace {

using namespace s2pa;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One block per word slot. Shared memory: qe row [E] f32, then [L] f32
// logits that become the rounded weights.
template <typename T>
__global__ void __launch_bounds__(kThreads)
s2pa_bank_fwd_kernel(const T* __restrict__ bank, const int32_t* __restrict__ wt,
                     const T* __restrict__ qe, const int32_t* __restrict__ km,
                     const float* __restrict__ mask, T* __restrict__ ctx,
                     float* __restrict__ w, int L, int E) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* p_s = q_s + E;
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* row = bank + static_cast<size_t>(wt[n]) * L * E;
  const T* q_n = qe + static_cast<size_t>(n) * E;
  const size_t nl = static_cast<size_t>(n) * L;

  for (int e = threadIdx.x; e < E; e += kThreads) q_s[e] = to_float(q_n[e]);
  __syncthreads();

  // phase 1: logits, one warp per gloss token, lanes along E
  constexpr int V = Vec16<T>::n;
  for (int l = warp; l < L; l += kWarps) {
    const T* r = row + static_cast<size_t>(l) * E;
    float acc = 0.f;
    for (int e = lane * V; e < E; e += 32 * V) {
      float x[V];
      Vec16<T>::load(r + e, x);
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_s + e + i);
        acc = fmaf(x[i], q4.x, acc);
        acc = fmaf(x[i + 1], q4.y, acc);
        acc = fmaf(x[i + 2], q4.z, acc);
        acc = fmaf(x[i + 3], q4.w, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) p_s[l] = km[nl + l] != 0 ? acc : kMaskValue;
  }
  __syncthreads();

  // phase 2: f32 softmax over L (one warp), write w, keep the rounded w*mask
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
    for (int l = lane; l < L; l += 32) {
      const float wl = p_s[l] / s;
      w[nl + l] = wl;
      p_s[l] = to_float(from_float<T>(wl * mask[nl + l]));
    }
  }
  __syncthreads();

  // phase 3: context, each thread owns columns e and sums over l (L2 re-read)
  T* out = ctx + static_cast<size_t>(n) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(p_s[l], to_float(row[static_cast<size_t>(l) * E + e]), acc);
    out[e] = from_float<T>(acc);
  }
}

}  // namespace

// Plain C entry point. Pointers are device pointers of contiguous tensors:
// bank [V, L, E], wt [N] int32, qe [N, E] (bank dtype), km [N, L] int32,
// mask [N, L] f32 -> ctx [N, E] (bank dtype), w [N, L] f32. E must be a
// multiple of 8. Returns the cudaError_t of the launch.
extern "C" int s2pa_bank_fwd(const void* bank, const void* wt, const void* qe, const void* km,
                             const void* mask, void* ctx, void* w, int n, int L, int E,
                             int is_bf16, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(E + L) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    s2pa_bank_fwd_kernel<__nv_bfloat16><<<n, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(bank), static_cast<const int32_t*>(wt),
        static_cast<const __nv_bfloat16*>(qe), static_cast<const int32_t*>(km),
        static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(ctx),
        static_cast<float*>(w), L, E);
  } else {
    s2pa_bank_fwd_kernel<float><<<n, kThreads, smem, s>>>(
        static_cast<const float*>(bank), static_cast<const int32_t*>(wt),
        static_cast<const float*>(qe), static_cast<const int32_t*>(km),
        static_cast<const float*>(mask), static_cast<float*>(ctx), static_cast<float*>(w), L, E);
  }
  return static_cast<int>(cudaGetLastError());
}
