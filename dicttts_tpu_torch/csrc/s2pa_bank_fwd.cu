// S2PA attention over the device-resident dict bank, forward (K1).
//
// Replaces the Pallas TPU kernel `s2pa_bank_attend` forward
// (dicttts_tpu/ops/s2pa_bank_pallas.py:128, `_fwd_call` -> `_fwd_kernel`).
// For each word slot n (N = B * Tw):
//   row      = bank[wt[n]]                         [L, E], gathered here
//   logits_l = row[l, :] . qe[n, :]                f32 accumulation
//   logits_l = -1e9 where km[n, l] == 0            finite mask: an all-masked
//                                                  row gives uniform weights
//   w        = softmax(logits)                     f32, written out (pre-dropout)
//   wd       = bank_type(w * mask[n])              rounded like the TPU kernel,
//                                                  after normalising
//   ctx[n]   = sum_l wd[l] * row[l, :]             f32 accumulation, stored
//                                                  in the bank type
//
// What bounds it on the H100: bytes. Each distinct word id's row is 147 KB
// in bf16 (295 KB in f32) at L=96, E=768, and is used for 4*L*E flops per
// slot, far below the card's ~295 flops per byte, so the floor is the
// distinct rows over 3.35 TB/s.
//
// The design reads each distinct row from device memory once and serves
// every slot that uses it from shared memory (s2pa_common.cuh has the
// pieces): slots are grouped by word id through the stable sort of the ids
// that the wrapper passes (`ids`, `order`); one cluster of C CTAs owns a chunk of up to
// kSegMax slots with one id; each CTA bulk-copies its contiguous slice of
// Lc = ceil(L / C) gloss tokens into shared memory (C = 4 in bf16 and 8 in
// f32 at the production shape: ~40 KB and 128 threads a CTA, so 4-5 CTAs
// share an SM and one CTA's copies and cluster syncs overlap the others'
// arithmetic). Per slot, all from shared memory:
//   1. logits of the slice's tokens, each warp taking every fourth token
//      with the query in its lanes' registers (token_dots); lane j of a
//      warp keeps its j-th token's logit;
//   2. the softmax statistics: each warp's max m_w and s_w = sum exp(x - m_w)
//      by warp reductions, published (one float4 a warp) and combined
//      across the cluster through distributed shared memory into
//      m = max m_w, s = sum s_w exp(m_w - m), the same bits in every CTA;
//   3. w = exp(x - m) / s written, wd rounded to the bank type after the
//      normalisation (a running rescaled sum, as flash attention keeps,
//      could not round there), kept for the slice's tokens;
//   4. the slice's partial ctx [E], each group of columns stored into the
//      shared memory of the CTA that owns it;
//   5. after a cluster sync, CTA r sums what it received for columns
//      [r E/C, (r+1) E/C) in rank order and stores them. No atomics:
//      results are bitwise repeatable; no CTA reads another's shared memory
//      after that sync, so none waits for the others before it exits.
// The [B, Tw, L, E] gathered copy that the plain version builds is never
// materialised.

#include <math.h>

#include "s2pa_common.cuh"

namespace {

using namespace s2pa;
namespace cg = cooperative_groups;

template <typename T, int NIT>
__global__ void __launch_bounds__(kBankThreads, 5)
s2pa_bank_fwd_kernel(const T* __restrict__ bank, const int32_t* __restrict__ ids,
                     const int64_t* __restrict__ order, const T* __restrict__ qe,
                     const int32_t* __restrict__ km, const float* __restrict__ mask,
                     T* __restrict__ ctx, float* __restrict__ w, int N, int L, int E) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int id, count;
  long long slot_of_lane;
  if (!owned_chunk(ids, order, N, static_cast<int>(blockIdx.x) / C, &id, &count, &slot_of_lane)) return;
  S2PA_MARK_START(count);

  const BankPlan plan = bank_plan(L, E, C, sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* row_s = reinterpret_cast<T*>(smem);
  float* recv = reinterpret_cast<float*>(smem + plan.recv);
  float* partial = reinterpret_cast<float*>(smem + plan.partial);
  float* wd_s = reinterpret_cast<float*>(smem + plan.tok);  // rounded w * mask of the slice
  float* wst = reinterpret_cast<float*>(smem + plan.wst);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + plan.bars);

  const int l0 = rank * plan.Lc;
  const int nl = max(0, min(plan.Lc, L - l0));
  const int tc = (nl + kChunks - 1) / kChunks;
  const int nchunks = nl > 0 ? (nl + tc - 1) / tc : 0;
  if (threadIdx.x == 0)
    start_row_slice(row_s, bank + (static_cast<size_t>(id) * L + l0) * E, nl, tc, E, bars);
  __syncthreads();
  S2PA_MARK(0, 1);
  int ready = 0;  // chunks of the slice this thread has waited for
  // the warp's tokens are l = warp + kBankWarps * j; lane j keeps token j's values
  const int nj = nl > warp ? (nl - warp + kBankWarps - 1) / kBankWarps : 0;
  const int my_l = warp + kBankWarps * lane;

  for (int k = 0; k < count; ++k) {
    const long long n = __shfl_sync(0xffffffffu, slot_of_lane, k + 1);
    const size_t nL = static_cast<size_t>(n) * L + l0;
    int my_km = 0;
    float my_mk = 0.f, my_x = -INFINITY;
    if (lane < nj) {
      my_km = km[nL + my_l];
      my_mk = mask[nL + my_l];
    }
    LaneRow<T, NIT> q[1];
    q[0].load(qe + static_cast<size_t>(n) * E, E, lane);

    // 1. logits of the warp's tokens, from the slice in shared memory
    float dot[1];
    token_dots(row_s, q, E, nj, warp, lane, tc, bars, ready, dot);
    if (lane < nj) my_x = my_km != 0 ? dot[0] : kMaskValue;
    S2PA_MARK(k, 2);
    // 2. the warp's softmax statistics, then the cluster's
    const float m_w = warp_max(my_x);
    const float s_w = warp_sum(lane < nj ? expf(my_x - m_w) : 0.f);
    if (lane == 0) *reinterpret_cast<float4*>(wst + 4 * warp) = make_float4(m_w, s_w, 0.f, 0.f);
    S2PA_MARK(k, 3);
    cluster.sync();
    S2PA_MARK(k, 4);
    const float3 st = combine_stats(cluster, wst, C, lane);
    S2PA_MARK(k, 5);

    // 3. weights out, w * mask rounded to the bank type after normalising
    if (lane < nj) {
      const float wl = expf(my_x - st.x) / st.y;
      w[nL + my_l] = wl;
      wd_s[my_l] = to_float(from_float<T>(wl * my_mk));
    }
    if (k == 0)
      while (ready < nchunks) mbar_wait(bars + ready++, 0);
    __syncthreads();
    S2PA_MARK(k, 6);

    // 4-5. the slice's partial context, summed across the cluster
    push_columns(cluster, row_s, wd_s, nl, E, plan, rank, recv, partial);
    S2PA_MARK(k, 7);
    cluster.sync();
    S2PA_MARK(k, 8);
    reduce_columns(recv, E, C, plan.Ec, rank, ctx + static_cast<size_t>(n) * E);
    S2PA_MARK(k, 9);
  }
  S2PA_MARK_END(10);
}

// The kernel instantiated for NIT = ceil(E / (32 V)) vector steps a lane.
template <typename T, int NIT = 1>
int launch_fwd(int nit, int n, int C, size_t smem, cudaStream_t s, const void* bank, const void* ids,
               const void* order, const void* qe, const void* km, const void* mask, void* ctx, void* w,
               int L, int E) {
  if constexpr (NIT < kMaxNit<T>) {
    if (nit > NIT) return launch_fwd<T, NIT + 1>(nit, n, C, smem, s, bank, ids, order, qe, km, mask, ctx, w, L, E);
  }
  return launch_cluster_grid(s2pa_bank_fwd_kernel<T, NIT>, n * C, C, kBankThreads, smem, s,
                             static_cast<const T*>(bank), static_cast<const int32_t*>(ids),
                             static_cast<const int64_t*>(order), static_cast<const T*>(qe),
                             static_cast<const int32_t*>(km),
                             static_cast<const float*>(mask), static_cast<T*>(ctx), static_cast<float*>(w), n,
                             L, E);
}

}  // namespace

// Plain C entry point. Pointers are device pointers of contiguous tensors:
// bank [V, L, E] (16-byte aligned), ids [N] int32 and order [N] int64 (the
// word ids sorted stably and their slots), qe [N, E] (bank dtype), km [N, L]
// int32, mask [N, L] f32 -> ctx [N, E] (bank dtype), w [N, L] f32. The
// cluster size and shared memory come from choose_plan; a shape it refuses
// returns cudaErrorInvalidValue. Returns the cudaError_t of the launch.
extern "C" int s2pa_bank_fwd(const void* bank, const void* ids, const void* order, const void* qe,
                             const void* km, const void* mask, void* ctx, void* w, int n, int L,
                             int E, int is_bf16, void* stream) {
  if (n == 0) return 0;
  int C;
  size_t smem;
  if (!s2pa::choose_plan(L, E, is_bf16 ? 2 : 4, &C, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>((E + 255) / 256, n, C, smem, s, bank, ids, order, qe, km, mask, ctx, w, L, E);
  return launch_fwd<float>((E + 127) / 128, n, C, smem, s, bank, ids, order, qe, km, mask, ctx, w, L, E);
}

// Host-side views of the bank kernels' plan and grouping, for the wrapper's
// checks and for tests. s2pa_bank_plan: the cluster size C and one CTA's
// shared memory in bytes for an [*, L, E] bank (is_bf16: 2-byte elements);
// returns 1 if the kernels take the shape, else 0. s2pa_bank_chunks: for
// word ids sorted stably (host memory, n of them), counts[i] = the number of
// slots in the chunk that starts at sorted position i, 0 where none starts.
extern "C" int s2pa_bank_plan(int L, int E, int is_bf16, int* C, long long* smem) {
  size_t bytes;
  const bool ok = s2pa::choose_plan(L, E, is_bf16 ? 2 : 4, C, &bytes);
  *smem = static_cast<long long>(bytes);
  return ok ? 1 : 0;
}

extern "C" void s2pa_bank_chunks(const int32_t* ids, int n, int32_t* counts) {
  int start = 0;
  for (int i = 0; i < n; ++i) {
    counts[i] = 0;
    if (s2pa::starts_chunk(i, ids[i], i > 0 ? ids[i - 1] : ids[i])) start = i;
    ++counts[start];
  }
}

#ifdef S2PA_PROFILE
// Profiling builds only (the marks' copy and clear are the header's): how
// many clusters of C CTAs with `smem` bytes each the card holds at once
// (the kernel at E = 768).
extern "C" int s2pa_prof_max_clusters(int C, int smem, int is_bf16) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4096 * C);
  cfg.blockDim = dim3(s2pa::kBankThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (is_bf16) {
    cudaFuncSetAttribute(s2pa_bank_fwd_kernel<__nv_bfloat16, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveClusters(&n, s2pa_bank_fwd_kernel<__nv_bfloat16, 3>, &cfg);
  } else {
    cudaFuncSetAttribute(s2pa_bank_fwd_kernel<float, 6>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveClusters(&n, s2pa_bank_fwd_kernel<float, 6>, &cfg);
  }
  return n;
}
#endif
