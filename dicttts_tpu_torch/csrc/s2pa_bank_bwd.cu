// S2PA attention over the device-resident dict bank, backward (K2).
//
// Replaces the Pallas TPU kernel `s2pa_bank_attend` backward
// (dicttts_tpu/ops/s2pa_bank_pallas.py:163, `_bwd_call` -> `_bwd_kernel`,
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
// What bounds it on the H100: bytes. Each distinct word id's row is 147 KB
// in bf16 (295 KB in f32) at L=96, E=768, used for 6*L*E flops per slot.
//
// The design is K1's (s2pa_bank_fwd.cu, s2pa_common.cuh): slots grouped by
// word id through the forward's saved sort of the ids (`ids`, `order`), one cluster of C CTAs per
// chunk of up to kSegMax slots with one id, each CTA holding a contiguous
// slice of the row's gloss tokens in shared memory after one bulk copy from
// device memory (C = 4 in bf16, 8 in f32; ~40 KB and 128 threads a CTA).
// Per slot, all from that one copy:
//   1. logits and d_wd of the slice's tokens in one pass (token_dots: each
//      warp takes every fourth token, qe and g_ctx in its lanes' registers);
//   2. the softmax statistics and the VJP's sum in one cluster reduction:
//      each warp publishes m_w, s_w = sum exp(x - m_w) and
//      t_w = sum exp(x - m_w) d_w; all take m = max m_w,
//      s = sum s_w exp(m_w - m), sum_k w_k d_w_k = (sum t_w exp(m_w - m)) / s;
//   3. d_logits, rounded to the bank type;
//   4. the slice's partial d_qe [E], each group of columns stored into the
//      shared memory of the CTA that owns it; after a cluster sync CTA r
//      sums what it received for columns [r E/C, (r+1) E/C) in rank order
//      and stores them.
// No atomics (bitwise repeatable), no bank gradient, nothing of size
// [N, L, E].

#include <math.h>

#include "s2pa_common.cuh"

namespace {

using namespace s2pa;
namespace cg = cooperative_groups;

// Five CTAs an SM in bf16 (the packed query and gradient leave registers
// to spare), four in f32.
template <typename T, int NIT>
__global__ void __launch_bounds__(kBankThreads, sizeof(T) == 2 ? 5 : 4)
s2pa_bank_bwd_kernel(const T* __restrict__ bank, const int32_t* __restrict__ ids,
                     const int64_t* __restrict__ order, const T* __restrict__ qe,
                     const int32_t* __restrict__ km, const float* __restrict__ mask,
                     const T* __restrict__ g_ctx, const float* __restrict__ g_w,
                     T* __restrict__ d_qe, int N, int L, int E) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int id, count;
  long long slot_of_lane;
  if (!owned_chunk(ids, order, N, static_cast<int>(blockIdx.x) / C, &id, &count, &slot_of_lane)) return;

  const BankPlan plan = bank_plan(L, E, C, sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* row_s = reinterpret_cast<T*>(smem);
  float* recv = reinterpret_cast<float*>(smem + plan.recv);
  float* partial = reinterpret_cast<float*>(smem + plan.partial);
  float* dl_s = reinterpret_cast<float*>(smem + plan.tok);  // rounded d_logits of the slice
  float* wst = reinterpret_cast<float*>(smem + plan.wst);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + plan.bars);

  const int l0 = rank * plan.Lc;
  const int nl = max(0, min(plan.Lc, L - l0));
  const int tc = (nl + kChunks - 1) / kChunks;
  const int nchunks = nl > 0 ? (nl + tc - 1) / tc : 0;
  if (threadIdx.x == 0)
    start_row_slice(row_s, bank + (static_cast<size_t>(id) * L + l0) * E, nl, tc, E, bars);
  __syncthreads();
  int ready = 0;  // chunks of the slice this thread has waited for
  // the warp's tokens are l = warp + kBankWarps * j; lane j keeps token j's values
  const int nj = nl > warp ? (nl - warp + kBankWarps - 1) / kBankWarps : 0;
  const int my_l = warp + kBankWarps * lane;

  for (int k = 0; k < count; ++k) {
    const long long n = __shfl_sync(0xffffffffu, slot_of_lane, k + 1);
    const size_t nL = static_cast<size_t>(n) * L + l0;
    int my_km = 0;
    float my_mk = 0.f, my_gw = 0.f, my_x = -INFINITY, my_dw = 0.f;
    if (lane < nj) {
      my_km = km[nL + my_l];
      my_mk = mask[nL + my_l];
      my_gw = g_w[nL + my_l];
    }
    LaneRow<T, NIT> qg[2];
    qg[0].load(qe + static_cast<size_t>(n) * E, E, lane);
    qg[1].load(g_ctx + static_cast<size_t>(n) * E, E, lane);

    // 1. logits and d_wd of the warp's tokens from one pass over the slice
    float dot[2];
    token_dots(row_s, qg, E, nj, warp, lane, tc, bars, ready, dot);
    if (lane < nj) {
      my_x = my_km != 0 ? dot[0] : kMaskValue;
      my_dw = dot[1] * my_mk + my_gw;
    }
    // 2. the warp's statistics (max, sum exp, sum exp * d_w), then the cluster's
    const float m_w = warp_max(my_x);
    const float e_w = lane < nj ? expf(my_x - m_w) : 0.f;
    const float s_w = warp_sum(e_w);
    const float t_w = warp_sum(e_w * my_dw);
    if (lane == 0) *reinterpret_cast<float4*>(wst + 4 * warp) = make_float4(m_w, s_w, t_w, 0.f);
    cluster.sync();
    const float3 st = combine_stats(cluster, wst, C, lane);
    const float wdw = st.z / st.y;  // sum_k w_k d_w_k

    // 3. d_logits, 0 where masked, rounded to the bank type
    if (lane < nj) {
      const float wl = expf(my_x - st.x) / st.y;
      dl_s[my_l] = to_float(from_float<T>(my_km != 0 ? wl * (my_dw - wdw) : 0.f));
    }
    if (k == 0)
      while (ready < nchunks) mbar_wait(bars + ready++, 0);
    __syncthreads();

    // 4. the slice's partial d_qe, summed across the cluster
    push_columns(cluster, row_s, dl_s, nl, E, plan, rank, recv, partial);
    cluster.sync();
    reduce_columns(recv, E, C, plan.Ec, rank, d_qe + static_cast<size_t>(n) * E);
  }
}

// The kernel instantiated for NIT = ceil(E / (32 V)) vector steps a lane.
template <typename T, int NIT = 1>
int launch_bwd(int nit, int n, int C, size_t smem, cudaStream_t s, const void* bank, const void* ids,
               const void* order, const void* qe, const void* km, const void* mask, const void* g_ctx,
               const void* g_w, void* d_qe, int L, int E) {
  if constexpr (NIT < kMaxNit<T>) {
    if (nit > NIT)
      return launch_bwd<T, NIT + 1>(nit, n, C, smem, s, bank, ids, order, qe, km, mask, g_ctx, g_w, d_qe, L, E);
  }
  return launch_cluster_grid(s2pa_bank_bwd_kernel<T, NIT>, n * C, C, kBankThreads, smem, s,
                             static_cast<const T*>(bank), static_cast<const int32_t*>(ids),
                             static_cast<const int64_t*>(order), static_cast<const T*>(qe),
                             static_cast<const int32_t*>(km),
                             static_cast<const float*>(mask), static_cast<const T*>(g_ctx),
                             static_cast<const float*>(g_w), static_cast<T*>(d_qe), n, L, E);
}

}  // namespace

// Plain C entry point. Pointers are device pointers of contiguous tensors:
// bank [V, L, E] (16-byte aligned), ids [N] int32 and order [N] int64 (the
// word ids sorted stably and their slots), qe [N, E] (bank dtype), km [N, L] int32, mask [N, L] f32,
// g_ctx [N, E] (bank dtype), g_w [N, L] f32 -> d_qe [N, E] (bank dtype).
// The cluster size and shared memory come from choose_plan; a shape it
// refuses returns cudaErrorInvalidValue. Returns the cudaError_t of the
// launch.
extern "C" int s2pa_bank_bwd(const void* bank, const void* ids, const void* order, const void* qe,
                             const void* km, const void* mask, const void* g_ctx, const void* g_w,
                             void* d_qe, int n, int L, int E, int is_bf16, void* stream) {
  if (n == 0) return 0;
  int C;
  size_t smem;
  if (!s2pa::choose_plan(L, E, is_bf16 ? 2 : 4, &C, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>((E + 255) / 256, n, C, smem, s, bank, ids, order, qe, km, mask, g_ctx, g_w,
                                     d_qe, L, E);
  return launch_bwd<float>((E + 127) / 128, n, C, smem, s, bank, ids, order, qe, km, mask, g_ctx, g_w, d_qe, L, E);
}
