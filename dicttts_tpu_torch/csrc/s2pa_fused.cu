// Fused S2PA forward over gathered, projected keys and values (K3).
//
// Replaces the Pallas TPU kernel `s2pa_fused`
// (dicttts_tpu/ops/s2pa_pallas.py:104, `_s2pa_kernel`). For each row n
// (N = B * T), with q already scaled (kernel scale 1.0):
//   logits_l = k[n, l, :] . q[n, :], -1e9 where key_map[n, l] == 0
//   w        = softmax(logits)        an all-masked row: uniform over its L
//   ctx[n]   = sum_l w[l] * v[n, l, :]
//   pron[p]  = sum_l w[l] * [key_map[n, l] == pinyin_map[n, p] != 0]
// all in one pass, all f32, any L >= 1 and P >= 1 (no lane padding), H a
// multiple of 4.
//
// What bounds it on the H100: bytes. k and v are [N, L, H] f32 and each
// element feeds one multiply-add, so the floor is reading k and v once over
// 3.35 TB/s (45 MB, 0.0135 ms on the text path at B=16, Tw=32, L=56,
// H=192). The kernel before this one (one block per row) asked for v only
// after the logits and the softmax, read k a warp per token in 4-byte loads
// and walked L serially per ctx column, and at B=1 (16-32 rows) used at
// most 32 of the 132 SMs; its clock marks put over half of a block's life
// in the logits and most of the rest in the ctx walk. This design:
//
// - bytes in flight from the start: a producer warp issues bulk async
//   copies (cp.async.bulk ... mbarrier::complete_tx) of a row's k tiles
//   and then its v tiles into a ring of S stages in shared memory, a
//   "full" mbarrier a stage; six consumer warps compute and release each
//   stage on its "empty" mbarrier, so neither side waits for the other at
//   a block-wide barrier. A tile is `tt` whole tokens (about 8 KB). The
//   ring takes what the R CTAs planned for an SM leave of its shared
//   memory: where a slice's k and v fit, every copy is issued at once and
//   v arrives while the logits and the softmax run; else the slice
//   streams, each stage refilled with the next tile (the next row's k
//   after this row's v) as soon as all six warps have released it. A
//   row's q, key_map and pinyin_map come by cp.async, queued ahead of the
//   bulk copies (behind them they waited ~11 us at B=16), the next row's
//   while this one runs.
// - every thread busy on 16-byte shared-memory reads: 192 consumer
//   threads; the logits take eight tokens a warp at a time, lanes along H
//   in float4 with q from shared memory, reduced by one transposed
//   butterfly (sum8_transposed); the ctx pass gives thread (g, p) column
//   group g (4 columns) and every Pg-th token of each tile, Pg = 192 /
//   (H / 4) (4 at H = 192: all threads), accumulated in shared memory
//   across tiles and summed over p in order at the end. No thread walks L
//   alone.
// - the card filled at small N: a row's L gloss tokens are split over a
//   cluster of C CTAs (C doubles up to 8 while N * C < 264 and each CTA
//   keeps at least 4 tokens; the B=1 text path gets C = 8). Each CTA
//   publishes its softmax max and sum; every CTA combines all C in rank
//   order through distributed shared memory (the same bits everywhere);
//   each then pushes its partial [ctx | pron] to the CTAs that own those
//   columns, and after a cluster sync each owner sums what it received in
//   rank order and stores. At large N, C = 1 and at most 4 x 132 CTAs,
//   each serving rows n, n + grid, ...: no launch waves, and the ring
//   prefetches a CTA's next row while it finishes this one.
// - the plan (C, the grid, tile tokens, stages, shared memory;
//   `choose_fused_plan`) is computed here only: the entry point launches
//   with it, and the library exports it (`s2pa_fused_plan`), which
//   dicttts_tpu_torch/ops/s2pa_fused.py::fused_kernel_plan calls to check
//   a shape before a launch.
// - no atomics: results are bitwise repeatable.

#include <math.h>

#include "s2pa_common.cuh"

// S2PA_PHASES: row 0's q, key_map, pinyin_map (cp.async)|logits over the k tiles|softmax statistics (cluster)|weights out, pron|ctx over the v tiles|combine (cluster) and store|later rows, exit

namespace {

using namespace s2pa;
namespace cg = cooperative_groups;

constexpr int kFusedThreads = 192;  // 6 consumer warps: at H = 192 the ctx pass's 48 column groups x 4 token groups
constexpr int kFusedWarps = kFusedThreads / 32;
constexpr int kBlockThreads = kFusedThreads + 32;  // and one producer warp
constexpr int kSms = 132;                  // the H100's SMs
constexpr int kMaxResident = 4;            // CTAs an SM: 4 x 224 threads at <= 72 registers (launch bounds)
constexpr size_t kSmemPerSm = 228 * 1024;  // of which 1 KB a CTA is the system's
constexpr int kMinSlice = 4;               // fewest gloss tokens a cluster's CTA takes
constexpr int kTileBytes = 8 * 1024;       // one bulk copy: whole tokens of k or v
constexpr int kPmCache = 256;              // pinyin_map entries a row fetches ahead (the rest are read in place)

// One CTA's work and shared memory (byte offsets): the ring [S, tt, H];
// q [2, H]; the ctx accumulators [Pg, H]; with C > 1 the partial [ctx |
// pron] [Gm float4 groups] and the receive buffer [C, Hcg float4 groups];
// the slice's logits, then weights [Lc]; its key_map [2, Lc]; pinyin_map
// [2, min(P, kPmCache)]; reduction scratch; S full and S empty
// mbarriers. q, key_map and pinyin_map are double-buffered: the next
// row's arrive while this one runs. grid: the CTAs launched.
struct FusedPlan {
  int C, grid, Lc, tt, nt, S, Pg, Gm, Hcg;
  size_t q, acc, part, recv, x, km, pm, red, bars, total;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ inline long long lmin(long long a, long long b) { return a < b ? a : b; }
__host__ __device__ inline long long lmax(long long a, long long b) { return a > b ? a : b; }

__host__ __device__ inline FusedPlan fused_layout(int L, int H, int P, int C, int S) {
  FusedPlan f;
  f.C = C;
  f.grid = 0;
  f.Lc = (L + C - 1) / C;
  f.tt = static_cast<int>(lmin(f.Lc, lmax(1, kTileBytes / (H * 4))));
  f.nt = (f.Lc + f.tt - 1) / f.tt;
  f.S = static_cast<int>(lmin(S, 2 * f.nt));
  const int G = H / 4;
  f.Pg = G >= kFusedThreads ? 1 : kFusedThreads / G;
  f.Gm = C > 1 ? (H + (P + 3) / 4 * 4) / 4 : 0;
  f.Hcg = C > 1 ? (f.Gm + C - 1) / C : 0;
  f.q = static_cast<size_t>(f.S) * f.tt * H * 4;
  f.acc = f.q + static_cast<size_t>(2) * H * 4;
  f.part = f.acc + static_cast<size_t>(f.Pg) * H * 4;
  f.recv = f.part + static_cast<size_t>(f.Gm) * 16;
  f.x = f.recv + static_cast<size_t>(C > 1 ? C : 0) * f.Hcg * 16;
  f.km = f.x + align16(static_cast<size_t>(f.Lc) * 4);
  f.pm = f.km + 2 * align16(static_cast<size_t>(f.Lc) * 4);
  f.red = f.pm + 2 * align16(static_cast<size_t>(lmin(P, kPmCache)) * 4);
  f.bars = f.red + 16 * (kFusedWarps + 1);
  f.total = f.bars + static_cast<size_t>(f.S) * 16;
  return f;
}

// The kernel's plan for N rows of [L, H] with P pinyin slots (the top of
// this file). C doubles while N * C < 2 * kSms and a CTA keeps kMinSlice
// tokens; R = ceil(N * C / kSms) CTAs an SM, at most kMaxResident; the
// ring takes what R CTAs leave of an SM's shared memory, at least one
// tile, at most the slice's k and v; with C > 1 it must hold all of them
// (a cluster's producer warps then never wait on the consumers, who sit in
// cluster syncs), else C halves; the grid is min(N, kSms * R / C)
// clusters, each serving rows n, n + clusters, ... Returns false for a
// shape it does not take (H not a positive multiple of 4, an empty axis,
// or more than kMaxSmem for one CTA even at C = 1 and one stage).
__host__ __device__ inline bool choose_fused_plan(int N, int L, int H, int P, FusedPlan* plan) {
  if (N < 1 || L < 1 || P < 1 || H < 4 || H % 4) return false;
  int C = 1;
  while (C < kMaxCluster && N * C < 2 * kSms && (L + 2 * C - 1) / (2 * C) >= kMinSlice) C *= 2;
  for (;; C /= 2) {
    const long long ctas = static_cast<long long>(N) * C;
    const int R = static_cast<int>(lmin(kMaxResident, (ctas + kSms - 1) / kSms));
    const FusedPlan bare = fused_layout(L, H, P, C, 0);
    const long long stage = static_cast<long long>(bare.tt) * H * 4 + 16;  // a tile and its two mbarriers
    const long long room = static_cast<long long>(kSmemPerSm / R) - 1024 - static_cast<long long>(bare.total);
    const int S = static_cast<int>(lmax(1, lmin(2 * bare.nt, room / stage)));
    *plan = fused_layout(L, H, P, C, S);
    plan->grid = C * static_cast<int>(lmin(N, lmax(1, kSms * R / C)));
    if (plan->total <= kMaxSmem && (C == 1 || plan->S == 2 * plan->nt)) return true;
    if (C == 1) return false;
  }
}

__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFusedThreads) : "memory");
}

__global__ void __launch_bounds__(kBlockThreads, kMaxResident)
s2pa_fused_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const int32_t* __restrict__ key_map, const int32_t* __restrict__ pinyin_map,
                  float* __restrict__ ctx, float* __restrict__ w, float* __restrict__ pron, int N, int L,
                  int H, int P, const FusedPlan plan) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = plan.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  // this cluster's rows: cl, cl + ncl, ...
  const int ncl = static_cast<int>(gridDim.x) / C, cl = static_cast<int>(blockIdx.x) / C;
  const int rows = cl < N ? (N - 1 - cl) / ncl + 1 : 0;
  S2PA_MARK_START(rows);

  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + plan.q);
  float4* acc4 = reinterpret_cast<float4*>(smem + plan.acc);
  float* part = reinterpret_cast<float*>(smem + plan.part);
  float* recv = reinterpret_cast<float*>(smem + plan.recv);
  float* x_s = reinterpret_cast<float*>(smem + plan.x);
  int32_t* km_s = reinterpret_cast<int32_t*>(smem + plan.km);
  int32_t* pm_s = reinterpret_cast<int32_t*>(smem + plan.pm);
  float* red = reinterpret_cast<float*>(smem + plan.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bars);  // tile landed in stage s
  uint64_t* empty = full + plan.S;                                   // every consumer warp done with stage s

  // this CTA's slice of a row: tokens [l0, l0 + nl), as even as C allows
  const int l0 = static_cast<int>(static_cast<long long>(rank) * L / C);
  const int nl = static_cast<int>(static_cast<long long>(rank + 1) * L / C) - l0;
  const int G = H / 4, S = plan.S, tt = plan.tt, Pg = plan.Pg;
  const int nt = (nl + tt - 1) / tt;  // a row's k tiles, then as many v tiles
  const int ntiles = 2 * nt * rows;   // tile i: row i / (2 nt), k or v tile i % (2 nt)
  const size_t stage = static_cast<size_t>(tt) * H;
  auto tile_tokens = [&](int i) { return min(tt, nl - (i % (2 * nt) % nt) * tt); };
  auto issue = [&](int i) {  // the producer: tile i into stage i % S
    const int j = i % (2 * nt);
    const size_t row = static_cast<size_t>(cl + i / (2 * nt) * ncl) * L + l0;
    const uint32_t bytes = static_cast<uint32_t>(tile_tokens(i)) * H * 4;
    mbar_expect_tx(full + i % S, bytes);
    bulk_load(ring + (i % S) * stage, (j < nt ? k : v) + (row + static_cast<size_t>(j % nt) * tt) * H, bytes,
              full + i % S);
  };
  // row r's q, key_map slice and first Pc pinyin_map entries into buffer r & 1
  const int Pc = min(P, kPmCache);
  const int kms = static_cast<int>(align16(static_cast<size_t>(plan.Lc) * 4) / 4);
  const int pms = static_cast<int>(align16(static_cast<size_t>(Pc) * 4) / 4);
  auto prefetch = [&](int r) {
    const int n = cl + r * ncl, b = r & 1;
    for (int g = t; g < G; g += kFusedThreads) cp_async16(q_s + b * H + 4 * g, q + static_cast<size_t>(n) * H + 4 * g);
    for (int l = t; l < nl; l += kFusedThreads)
      cp_async4(km_s + b * kms + l, key_map + static_cast<size_t>(n) * L + l0 + l);
    for (int p = t; p < Pc; p += kFusedThreads) cp_async4(pm_s + b * pms + p, pinyin_map + static_cast<size_t>(n) * P + p);
  };
  // row 0's small inputs first, so they do not wait behind the bulk copies
  const bool producer = warp == kFusedWarps;
  if (!producer && rows > 0) prefetch(0);
  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFusedWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist; the small copies are already queued ahead of the bulk ones
  // the producer warp: one lane issues every tile, each into a stage once
  // every consumer warp has released the tile before it there. With C > 1
  // the plan gives the CTAs one row and no refills, so the warp never
  // waits, and it joins the consumers' two cluster syncs before it exits.
  if (producer) {
    if (lane == 0)
      for (int i = 0; i < ntiles; ++i) {
        if (i >= S) mbar_wait(empty + i % S, ((i / S) - 1) & 1);
        issue(i);
      }
    __syncwarp();
    if (C > 1)
      for (int r = 0; r < 2 * rows; ++r) cluster.sync();
    return;
  }
  auto release = [&](int i) {  // this warp is done with tile i
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % S);
  };
  cp_async_wait_all();
  sync_consumers();
  S2PA_MARK(0, 1);

  for (int r = 0; r < rows; ++r) {
    const int n = cl + r * ncl;
    const size_t row = static_cast<size_t>(n) * L + l0;
    const int i0 = r * 2 * nt;
    const float* qr = q_s + (r & 1) * H;
    const int32_t* kmr = km_s + (r & 1) * kms;
    const int32_t* pmr = pm_s + (r & 1) * pms;
    if (r + 1 < rows) prefetch(r + 1);
    // each thread zeroes the accumulators it alone uses below
    for (int e = t; e < Pg * G; e += kFusedThreads) acc4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = H + t; e < 4 * plan.Gm; e += kFusedThreads) part[e] = 0.f;  // pron and its padding

    // logits: warp w takes tokens w, w + 6, ... of each k tile, eight at once
    for (int j = 0; j < nt; ++j) {
      const int i = i0 + j;
      mbar_wait(full + i % S, (i / S) & 1);
      const float* tile = ring + (i % S) * stage;
      const int ntok = tile_tokens(i);
      for (int j0 = warp; j0 < ntok; j0 += 8 * kFusedWarps) {
        float acc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u] = 0.f;
        for (int g = lane; g < G; g += 32) {
          const float4 qv = reinterpret_cast<const float4*>(qr)[g];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (j0 + u * kFusedWarps < ntok) {
              const float4 kv =
                  reinterpret_cast<const float4*>(tile + static_cast<size_t>(j0 + u * kFusedWarps) * H)[g];
              acc[u] = fmaf(kv.x, qv.x, acc[u]);
              acc[u] = fmaf(kv.y, qv.y, acc[u]);
              acc[u] = fmaf(kv.z, qv.z, acc[u]);
              acc[u] = fmaf(kv.w, qv.w, acc[u]);
            }
          }
        }
        const float dot = sum8_transposed(acc, lane);  // lane u < 8: token j0 + 6u's
        const int tok = j0 + lane * kFusedWarps;
        if (lane < 8 && tok < ntok) {
          const int l = j * tt + tok;
          x_s[l] = kmr[l] != 0 ? dot : kMaskValue;
        }
      }
      release(i);
    }
    sync_consumers();
    S2PA_MARK(r, 2);

    // softmax statistics of the slice, then of the row (rank order, all CTAs the same bits)
    float m = -INFINITY;
    for (int l = t; l < nl; l += kFusedThreads) m = fmaxf(m, x_s[l]);
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    sync_consumers();
    m = red[0];
    for (int i = 1; i < kFusedWarps; ++i) m = fmaxf(m, red[i]);
    float s = 0.f;
    for (int l = t; l < nl; l += kFusedThreads) s += expf(x_s[l] - m);
    s = warp_sum(s);
    if (lane == 0) red[kFusedWarps + warp] = s;
    sync_consumers();
    s = red[kFusedWarps];
    for (int i = 1; i < kFusedWarps; ++i) s += red[kFusedWarps + i];
    if (C > 1) {
      float2* st = reinterpret_cast<float2*>(red + 2 * kFusedWarps);
      if (t == 0) *st = make_float2(m, s);
      cluster.sync();
      float mc = -INFINITY, sc = 0.f;
      for (int c = 0; c < C; ++c) mc = fmaxf(mc, cluster.map_shared_rank(st, c)->x);
      for (int c = 0; c < C; ++c) {
        const float2 o = *cluster.map_shared_rank(st, c);
        if (o.y > 0.f) sc += o.y * expf(o.x - mc);
      }
      m = mc;
      s = sc;
    }
    S2PA_MARK(r, 3);

    // weights out (kept in x_s), then pron from the slice while v arrives
    for (int l = t; l < nl; l += kFusedThreads) {
      const float wl = expf(x_s[l] - m) / s;
      x_s[l] = wl;
      w[row + l] = wl;
    }
    sync_consumers();
    for (int p = warp; p < P; p += kFusedWarps) {
      const int32_t sense = p < Pc ? pmr[p] : pinyin_map[static_cast<size_t>(n) * P + p];
      float a = 0.f;
      if (sense != 0)
        for (int l = lane; l < nl; l += 32) a += kmr[l] == sense ? x_s[l] : 0.f;
      a = warp_sum(a);
      if (lane == 0) {
        if (C == 1)
          pron[static_cast<size_t>(n) * P + p] = a;
        else
          part[H + p] = a;
      }
    }
    S2PA_MARK(r, 4);

    // ctx: thread (g, p) = (e % G, e / G) sums tokens p, p + Pg, ... of each v tile
    for (int j = 0; j < nt; ++j) {
      const int i = i0 + nt + j;
      mbar_wait(full + i % S, (i / S) & 1);
      const float4* tile = reinterpret_cast<const float4*>(ring + (i % S) * stage);
      const float* wt = x_s + j * tt;
      const int ntok = tile_tokens(i);
      for (int e = t; e < Pg * G; e += kFusedThreads) {
        const int g = e % G, p = e / G;
        float4 a = acc4[e];
        int u = p;
        for (; u + 3 * Pg < ntok; u += 4 * Pg) {  // four tokens' loads in flight
          float4 x[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) x[b] = tile[static_cast<size_t>(u + b * Pg) * G + g];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float c = wt[u + b * Pg];
            a.x = fmaf(c, x[b].x, a.x);
            a.y = fmaf(c, x[b].y, a.y);
            a.z = fmaf(c, x[b].z, a.z);
            a.w = fmaf(c, x[b].w, a.w);
          }
        }
        for (; u < ntok; u += Pg) {
          const float4 x = tile[static_cast<size_t>(u) * G + g];
          const float c = wt[u];
          a.x = fmaf(c, x.x, a.x);
          a.y = fmaf(c, x.y, a.y);
          a.z = fmaf(c, x.z, a.z);
          a.w = fmaf(c, x.w, a.w);
        }
        acc4[e] = a;
      }
      release(i);
    }
    sync_consumers();
    S2PA_MARK(r, 5);

    // the slice's ctx: the Pg partial sums in order; stored (C = 1) or combined across the cluster
    float4* ctx4 = reinterpret_cast<float4*>(ctx + static_cast<size_t>(n) * H);
    for (int g = t; g < G; g += kFusedThreads) {
      float4 a = acc4[g];
      for (int p = 1; p < Pg; ++p) {
        const float4 b = acc4[p * G + g];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      if (C == 1)
        ctx4[g] = a;
      else
        reinterpret_cast<float4*>(part)[g] = a;
    }
    if (C > 1) {
      sync_consumers();
      const int Gm = plan.Gm, Hcg = plan.Hcg;
      for (int gm = t; gm < Gm; gm += kFusedThreads) {  // group gm belongs to rank gm / Hcg
        const int owner = gm / Hcg;
        float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(recv, owner));
        dst[rank * Hcg + gm - owner * Hcg] = reinterpret_cast<const float4*>(part)[gm];
      }
      cluster.sync();  // after it no CTA reads another's shared memory for this row
      const float4* recv4 = reinterpret_cast<const float4*>(recv);
      for (int jg = t; jg < Hcg && rank * Hcg + jg < Gm; jg += kFusedThreads) {
        float4 a = recv4[jg];
        for (int c = 1; c < C; ++c) {
          const float4 b = recv4[c * Hcg + jg];
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        const int gm = rank * Hcg + jg;
        if (gm < G) {
          ctx4[gm] = a;
        } else {
          const float c4[4] = {a.x, a.y, a.z, a.w};
          for (int b = 0; b < 4; ++b) {
            const int p = 4 * (gm - G) + b;
            if (p < P) pron[static_cast<size_t>(n) * P + p] = c4[b];
          }
        }
      }
    }
    S2PA_MARK(r, 6);
    cp_async_wait_all();  // the next row's q, key_map, pinyin_map
    sync_consumers();      // ... visible to all; this row's x_s, acc and part free
  }
  S2PA_MARK_END(7);
}

}  // namespace

// Plain C entry point. Device pointers of contiguous tensors, all 16-byte
// aligned: q [N, H], k and v [N, L, H], key_map [N, L] int32, pinyin_map
// [N, P] int32, floats f32 -> ctx [N, H], w [N, L], pron [N, P]. The plan
// comes from choose_fused_plan; a shape it refuses returns
// cudaErrorInvalidValue. Returns the cudaError_t of the launch.
extern "C" int s2pa_fused(const void* q, const void* k, const void* v, const void* key_map,
                          const void* pinyin_map, void* ctx, void* w, void* pron, int n, int L, int H, int P,
                          void* stream) {
  if (n == 0) return 0;
  FusedPlan plan;
  if (!choose_fused_plan(n, L, H, P, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_grid(s2pa_fused_kernel, plan.grid, plan.C, kBlockThreads, plan.total,
                             static_cast<cudaStream_t>(stream), static_cast<const float*>(q),
                             static_cast<const float*>(k), static_cast<const float*>(v),
                             static_cast<const int32_t*>(key_map), static_cast<const int32_t*>(pinyin_map),
                             static_cast<float*>(ctx), static_cast<float*>(w), static_cast<float*>(pron), n, L,
                             H, P, plan);
}

// Host-side view of K3's plan, for the wrapper's check and for tests: for N
// rows of [L, H] with P pinyin slots, out = {C (CTAs a cluster, a row's L
// split over them), CTAs launched, tile tokens, ring stages, k tiles a
// CTA's slice, threads a CTA} and *smem = one CTA's shared memory in
// bytes. Returns 1 if the kernel takes the shape, else 0.
extern "C" int s2pa_fused_plan(int n, int L, int H, int P, int* out, long long* smem) {
  FusedPlan plan = {};
  const bool ok = choose_fused_plan(n, L, H, P, &plan);
  out[0] = plan.C;
  out[1] = plan.grid;
  out[2] = plan.tt;
  out[3] = plan.S;
  out[4] = plan.nt;
  out[5] = kBlockThreads;
  *smem = static_cast<long long>(plan.total);
  return ok ? 1 : 0;
}
