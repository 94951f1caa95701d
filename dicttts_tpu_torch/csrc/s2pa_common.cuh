// Device helpers shared by the S2PA kernels: warp reductions and the
// transposed eight-way warp sum, bf16/f32 conversion, 16-byte vector loads
// widened to f32, profile marks, mbarriers, bulk and small asynchronous
// copies, and the cluster launch (the bank kernels s2pa_bank_fwd.cu and
// s2pa_bank_bwd.cu, and the fused forward s2pa_fused.cu); then the
// machinery the two bank kernels use to hold one bank row in the shared
// memory of a thread-block cluster:
//
// - slot grouping: the wrapper passes the word ids sorted stably and their
//   slots (`ids`, `order`: one torch.sort), so slots that read the same row
//   are neighbours. Cluster i looks at sorted position i and owns a chunk
//   of slots if the id there differs from its predecessor's or i is a
//   multiple of kSegMax; the chunk runs on while the id stays the same, up
//   to the next multiple of kSegMax. Every slot is in exactly one chunk, a
//   chunk holds at most kSegMax slots (so a frequent word has no long
//   serial tail), and all other clusters exit at once. A row whose slots
//   straddle a multiple of kSegMax is loaded by two clusters that run at
//   about the same time, so the second read is served by L2. The rule is
//   `starts_chunk`; the library exports it for host arrays
//   (`s2pa_bank_chunks`, in s2pa_bank_fwd.cu), which
//   dicttts_tpu_torch/ops/s2pa_bank.py::bank_slot_chunks calls.
// - the row split: the C CTAs of a cluster split the row's L gloss tokens
//   into contiguous slices of Lc = ceil(L / C) tokens. Each CTA copies its
//   slice, which is contiguous in the [V, L, E] bank, into shared memory
//   with 1-D bulk async copies (cp.async.bulk ... mbarrier::complete_tx) in
//   kChunks pieces, each with its own mbarrier, so the first dot products
//   start while the rest of the slice is in flight.
// - cluster reductions through distributed shared memory: each warp
//   publishes its softmax statistics (one float4), the cluster syncs, and
//   every CTA reads all of them in rank order; then each CTA stores its
//   partial sums of the output into the shared memory of the CTA that owns
//   those columns, the cluster syncs, and each CTA sums what it received in
//   rank order. After that sync no CTA touches another's shared memory, so
//   none waits for the others before it exits. No atomics: results are
//   bitwise repeatable.
// - occupancy: 128 threads and ~40 KB of shared memory a CTA at the
//   production shape (C = 4 in bf16, 8 in f32), so 4-5 CTAs share an SM
//   and one CTA's copies and cluster syncs overlap the others' arithmetic.
//
// The cluster size and the shared-memory plan of one CTA (`choose_plan`,
// `bank_plan` below) are computed here only: the entry points call them,
// and the library exports them (`s2pa_bank_plan`), which
// dicttts_tpu_torch/ops/s2pa_bank.py::bank_kernel_plan calls to check a
// shape before a launch.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s2pa {

constexpr float kMaskValue = -1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Eight per-lane values v[0..7] summed over the warp at once: one
// transposed butterfly (4 + 2 + 1 + 2 shuffles instead of 8 x 5) leaves
// the sum of v[t] in lanes 4t..4t+3; returned in every lane j, the sum of
// v[j & 7].
__device__ __forceinline__ float sum8_transposed(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float u4[4], u2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u4[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    u2[i] = (b3 ? u4[i + 2] : u4[i]) + __shfl_xor_sync(0xffffffffu, b3 ? u4[i] : u4[i + 2], 8);
  float u = (b2 ? u2[1] : u2[0]) + __shfl_xor_sync(0xffffffffu, b2 ? u2[0] : u2[1], 4);
  u += __shfl_xor_sync(0xffffffffu, u, 2);
  u += __shfl_xor_sync(0xffffffffu, u, 1);
  return __shfl_sync(0xffffffffu, u, (lane & 7) * 4);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16-byte vectors of consecutive elements (global or shared memory),
// widened to f32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void widen(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    widen(*reinterpret_cast<const uint4*>(p), out);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void widen(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    widen(*reinterpret_cast<const uint4*>(p), out);
  }
};

// ---- profile marks ------------------------------------------------------

#ifdef S2PA_PROFILE
// Profiling builds only, of one source at a time (-DS2PA_PROFILE:
// scripts/torch_bank_kernels_profile.py builds s2pa_bank_fwd.cu,
// scripts/torch_bank_kernels_ab.py --profile builds s2pa_fused.cu): thread
// 0 of every CTA that does work records clock64() at the kernel's marks
// (entries 0-10; K1 at its first slot's), %globaltimer at its start and end
// (12, 13), its SM (14) and a count of its own (15; K1: its slots). The
// kernels' own builds compile the marks to nothing.
constexpr int kProfCtas = 100000;
__device__ unsigned long long g_prof[kProfCtas * 16];
__device__ __forceinline__ void prof_put(int i, unsigned long long v) {
  if (threadIdx.x == 0 && blockIdx.x < kProfCtas) g_prof[static_cast<size_t>(blockIdx.x) * 16 + i] = v;
}
__device__ __forceinline__ unsigned long long prof_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned prof_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define S2PA_MARK(k, i)                                            \
  do {                                                             \
    if ((k) == 0) ::s2pa::prof_put(i, clock64());                  \
  } while (0)
#define S2PA_MARK_START(count)                                     \
  do {                                                             \
    ::s2pa::prof_put(0, clock64());                                \
    ::s2pa::prof_put(12, ::s2pa::prof_globaltimer());              \
    ::s2pa::prof_put(14, ::s2pa::prof_smid());                     \
    ::s2pa::prof_put(15, static_cast<unsigned long long>(count));  \
  } while (0)
#define S2PA_MARK_END(i)                                           \
  do {                                                             \
    ::s2pa::prof_put(i, clock64());                                \
    ::s2pa::prof_put(13, ::s2pa::prof_globaltimer());              \
  } while (0)
}  // namespace s2pa
// Read and clear the marks (host).
extern "C" int s2pa_prof_copy(void* dst, size_t bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, s2pa::g_prof, bytes));
}
extern "C" int s2pa_prof_clear() {
  void* p;
  cudaGetSymbolAddress(&p, s2pa::g_prof);
  return static_cast<int>(cudaMemset(p, 0, sizeof(s2pa::g_prof)));
}
namespace s2pa {
#else
#define S2PA_MARK(k, i) ((void)0)
#define S2PA_MARK_START(count) ((void)0)
#define S2PA_MARK_END(i) ((void)0)
#endif

// ---- the bank kernels' cluster layout ------------------------------------

// 128 threads a CTA and clusters of 4 (bf16) or 8 (f32) CTAs: CTAs of 256
// or 512 threads with clusters of 2 or 1 (2 or 1 CTAs an SM) were slower
// in bf16 (PERF.md section 6).
constexpr int kBankThreads = 128;
constexpr int kBankWarps = kBankThreads / 32;
constexpr int kSegMax = 4;      // most slots one cluster serves from one row load
constexpr int kChunks = 2;      // bulk copies (and mbarriers) per row slice
constexpr int kMaxE = 1024;     // a lane holds E / 32 query values in registers
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kMaxLc = 32 * kBankWarps;  // a slice's tokens: one lane each
static_assert(kMaxCluster * kBankWarps <= 32, "combine_stats reads one warp's statistics a lane");
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a CTA may use on the H100

// Sorted position i (word id `id`, its predecessor's `prev`) starts a chunk
// of slots: the grouping rule at the top of this file.
__host__ __device__ inline bool starts_chunk(int i, int id, int prev) {
  return i == 0 || i % kSegMax == 0 || id != prev;
}

// Byte offsets of one CTA's dynamic shared memory: the row slice [Lc, E]
// (bank type); the receive buffer [C, Ec] f32 into which every CTA of the
// cluster stores its partial sums of this CTA's Ec output columns; when the
// column pass has P > 1 token groups, their partial sums [P, E] f32; Lc f32
// per-token coefficients; one float4 of softmax statistics per warp;
// kChunks mbarriers.
struct BankPlan {
  int Lc, P, Ec;
  size_t recv, partial, tok, wst, bars, total;
};

__host__ __device__ inline BankPlan bank_plan(int L, int E, int C, int elt) {
  BankPlan p;
  p.Lc = (L + C - 1) / C;
  const int groups = E / (16 / elt);
  p.P = groups >= kBankThreads ? 1 : kBankThreads / groups;
  p.Ec = (E + 8 * C - 1) / (8 * C) * 8;  // a multiple of 8: no vector group straddles two CTAs
  p.recv = static_cast<size_t>(p.Lc) * E * elt;  // a multiple of 16: E % 8 == 0
  p.partial = p.recv + static_cast<size_t>(C) * p.Ec * 4;
  p.tok = p.partial + (p.P > 1 ? static_cast<size_t>(p.P) * E * 4 : 0);
  p.wst = (p.tok + static_cast<size_t>(p.Lc) * 4 + 15) / 16 * 16;
  p.bars = p.wst + kBankWarps * 16;
  p.total = p.bars + kChunks * 8;
  return p;
}

// The kernels' cluster size for an [*, L, E] bank with `elt`-byte elements:
// C = 4 CTAs in bf16 and 8 in f32 (a slice of about 37 KB of the row at
// L=96, E=768, so 4-5 CTAs of 128 threads share an SM), doubled up to
// kMaxCluster while a CTA would hold more than kMaxLc tokens or kMaxSmem
// bytes. Returns false for a shape the kernels do not take (E not a
// multiple of 8, E > kMaxE, or too large at kMaxCluster); *C and *smem are
// set either way (the last size tried).
__host__ __device__ inline bool choose_plan(int L, int E, int elt, int* C, size_t* smem) {
  *C = elt == 2 ? 4 : 8;
  *smem = 0;
  if (L < 1 || E < 8 || E % 8 || E > kMaxE) return false;
  for (;; *C *= 2) {
    *smem = bank_plan(L, E, *C, elt).total;
    if (*smem <= kMaxSmem && (L + *C - 1) / *C <= kMaxLc) return true;
    if (*C >= kMaxCluster) return false;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Bulk async copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to this CTA's shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4- and 16-byte asynchronous copies from global to shared memory
// (cp.async): issued by each thread for its own elements, completed for
// the thread by cp_async_wait_all (then a barrier makes them visible to
// the others). Small per-row data fetched this way does not wait in line
// behind the bulk copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The chunk of sorted slots that cluster `i` owns (see the top of this
// file). Every warp calls it and gets the same answer. Returns false if the
// cluster owns none; else sets *id (the word id), *count (slots, 1 to
// kSegMax) and, in lane k + 1 of `slot`, the k-th slot of the chunk (read
// it with __shfl_sync(..., k + 1)).
__device__ __forceinline__ bool owned_chunk(const int32_t* __restrict__ ids,
                                            const int64_t* __restrict__ order, int n, int i,
                                            int* id, int* count, long long* slot) {
  const int lane = threadIdx.x & 31;
  const int p = i - 1 + lane;  // lane 0: the predecessor; lanes 1..kSegMax: the chunk
  long long s = -1;
  int pid = -1;
  if (lane <= kSegMax && p >= 0 && p < n) {
    s = order[p];
    pid = ids[p];
  }
  const int my_id = __shfl_sync(0xffffffffu, pid, 1);
  const int prev = __shfl_sync(0xffffffffu, pid, 0);
  if (!starts_chunk(i, my_id, prev)) return false;
  // slot k > 0 continues the chunk if it starts none (its predecessor, in
  // the chunk, has my_id)
  const bool match = lane == 1 || (lane >= 2 && lane <= kSegMax && p < n && !starts_chunk(p, pid, my_id));
  const unsigned m = __ballot_sync(0xffffffffu, match) >> 1;  // bit k: slot k belongs
  *id = my_id;
  *count = __ffs(~m) - 1;
  *slot = s;
  return true;
}

// Thread 0: initialise the slice's mbarriers and start its bulk copies
// (tokens [0, nl) of the slice, from `src`, in chunks of `tc` tokens).
template <typename T>
__device__ __forceinline__ void start_row_slice(T* dst, const T* src, int nl, int tc, int E, uint64_t* bars) {
  const int nchunks = nl > 0 ? (nl + tc - 1) / tc : 0;
  for (int c = 0; c < nchunks; ++c) mbar_init(bars + c, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * tc;
    const int nt = min(tc, nl - t0);
    const uint32_t bytes = static_cast<uint32_t>(nt) * E * sizeof(T);
    mbar_expect_tx(bars + c, bytes);
    bulk_load(dst + static_cast<size_t>(t0) * E, src + static_cast<size_t>(t0) * E, bytes, bars + c);
  }
}

// A lane's share of a query row, kept in registers in the bank type (bf16
// stays packed): NIT 16-byte vector steps, columns (it * 32 + lane) * V +
// [0, V). The kernels are instantiated for NIT = ceil(E / (32 V)), so no
// register holds a column past E.
template <typename T, int NIT>
struct LaneRow {
  uint4 raw[NIT];
  __device__ __forceinline__ void load(const T* __restrict__ q, int E, int lane) {
#pragma unroll
    for (int it = 0; it < NIT; ++it) {
      const int col = (it * 32 + lane) * Vec16<T>::n;
      raw[it] = col < E ? *reinterpret_cast<const uint4*>(q + col) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// Phase 1 of a slot, for one warp: the dot products of NQ lane-held query
// rows with the warp's tokens l = warp + kBankWarps * j (j < nj) of the
// slice in shared memory, waiting for each token's bulk copy on its first
// use. Eight tokens at a time: all their loads are issued first, then one
// transposed butterfly (4 + 2 + 1 + 2 shuffles instead of 8 x 5) leaves
// token t's sum in lanes 4t..4t+3, and lane j takes token j's sum into
// out[qi] (lanes j >= nj get 0).
template <typename T, int NIT, int NQ>
__device__ __forceinline__ void token_dots(const T* row_s, const LaneRow<T, NIT> (&q)[NQ], int E, int nj,
                                           int warp, int lane, int tc, uint64_t* bars, int& ready,
                                           float (&out)[NQ]) {
  constexpr int V = Vec16<T>::n;
#pragma unroll
  for (int qi = 0; qi < NQ; ++qi) out[qi] = 0.f;
  for (int j0 = 0; j0 < nj; j0 += 8) {
    float v[NQ][8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int qi = 0; qi < NQ; ++qi) v[qi][t] = 0.f;
      if (j0 + t < nj) {
        const int l = warp + kBankWarps * (j0 + t);
        while (ready <= l / tc) mbar_wait(bars + ready++, 0);
        const T* r = row_s + static_cast<size_t>(l) * E;
#pragma unroll
        for (int it = 0; it < NIT; ++it) {
          const int col = (it * 32 + lane) * V;
          if (col < E) {
            float x[V];
            Vec16<T>::load(r + col, x);
#pragma unroll
            for (int qi = 0; qi < NQ; ++qi) {
              float y[V];
              Vec16<T>::widen(q[qi].raw[it], y);
#pragma unroll
              for (int i = 0; i < V; ++i) v[qi][t] = fmaf(x[i], y[i], v[qi][t]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
      const float mine = sum8_transposed(v[qi], lane);
      if (lane >= j0 && lane < j0 + 8) out[qi] = mine;
    }
  }
}

// After a cluster sync: every warp combines the C x kBankWarps published
// (max, sum exp, third sum) statistics, in lane order, into the cluster's
// max m and its sums rescaled to m. Every warp of every CTA gets the same
// bits.
__device__ __forceinline__ float3 combine_stats(cooperative_groups::cluster_group& cluster, float* wst, int C,
                                                int lane) {
  float4 st = make_float4(-INFINITY, 0.f, 0.f, 0.f);
  if (lane < C * kBankWarps)
    st = *reinterpret_cast<const float4*>(cluster.map_shared_rank(wst, lane / kBankWarps) + 4 * (lane % kBankWarps));
  const float m = warp_max(st.x);
  const float scale = st.y > 0.f ? expf(st.x - m) : 0.f;
  return make_float3(m, warp_sum(st.y * scale), warp_sum(st.z * scale));
}

// Column pass, pushed across the cluster: thread (g, p) = (t % G, t / G)
// with G = E / V sums coef[l] * row[l, g*V : (g+1)*V] over tokens
// l = p, p + P, ... of the slice; the V sums (after the P groups are summed
// in order, if P > 1) go to the CTA that owns those columns, row `rank` of
// its receive buffer, by stores to distributed shared memory. No CTA reads
// another's shared memory after the cluster sync that follows, so none has
// to wait for the others before it exits.
template <typename T>
__device__ __forceinline__ void push_columns(cooperative_groups::cluster_group& cluster, const T* row_s,
                                             const float* coef, int nl, int E, const BankPlan& plan,
                                             int rank, float* recv, float* partial) {
  constexpr int V = Vec16<T>::n;
  const int G = E / V, P = plan.P, Ec = plan.Ec;
  for (int t = threadIdx.x; t < G * P; t += kBankThreads) {
    const int g = t % G, p = t / G;
    const T* col = row_s + g * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    int l = p;
    for (; l + 3 * P < nl; l += 4 * P) {  // four tokens' loads in flight
      float x[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) Vec16<T>::load(col + static_cast<size_t>(l + u * P) * E, x[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float c = coef[l + u * P];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(c, x[u][k], acc[k]);
      }
    }
    for (; l < nl; l += P) {
      float x[V];
      Vec16<T>::load(col + static_cast<size_t>(l) * E, x);
      const float c = coef[l];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(c, x[k], acc[k]);
    }
    const int e = g * V, q = e / Ec;
    float* out = P > 1 ? partial + static_cast<size_t>(p) * E + e
                       : cluster.map_shared_rank(recv, q) + rank * Ec + (e - q * Ec);
#pragma unroll
    for (int k = 0; k < V; k += 4) *reinterpret_cast<float4*>(out + k) = make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
  }
  if (P > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kBankThreads) {
      float acc = partial[e];
      for (int p = 1; p < P; ++p) acc += partial[static_cast<size_t>(p) * E + e];
      const int q = e / Ec;
      cluster.map_shared_rank(recv, q)[rank * Ec + (e - q * Ec)] = acc;
    }
  }
}

// After the cluster sync that follows push_columns: sum the C rows of this
// CTA's receive buffer, in rank order, and store its columns
// [rank * Ec, (rank + 1) * Ec), four a thread.
template <typename T>
__device__ __forceinline__ void reduce_columns(const float* recv, int E, int C, int Ec, int rank,
                                               T* __restrict__ out) {
  const int c0 = rank * Ec;
  const int n = min(E - c0, Ec);
  for (int e = 4 * threadIdx.x; e < n; e += 4 * kBankThreads) {
    float4 acc = *reinterpret_cast<const float4*>(recv + e);
    for (int q = 1; q < C; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(recv + q * Ec + e);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    out[c0 + e] = from_float<T>(acc.x);
    out[c0 + e + 1] = from_float<T>(acc.y);
    out[c0 + e + 2] = from_float<T>(acc.z);
    out[c0 + e + 3] = from_float<T>(acc.w);
  }
}

// Vector steps of a lane's query share: NIT = ceil(E / (32 V)), 1 to kMaxNit.
template <typename T>
constexpr int kMaxNit = kMaxE / (32 * Vec16<T>::n);

// Launch `kernel` over `ctas` CTAs of `threads` threads in clusters of C
// (ctas a multiple of C; C = 1: no cluster attribute, each CTA its own
// cluster of one), with `smem` bytes of dynamic shared memory each.
// Returns the cudaError_t.
template <typename... Params, typename... Args>
inline int launch_cluster_grid(void (*kernel)(Params...), int ctas, int C, int threads, size_t smem,
                               cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace s2pa
