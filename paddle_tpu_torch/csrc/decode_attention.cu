// Ragged KV-cache decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py:_kernel
// (reached through ragged_decode_attention, decode_attention.py:118): one
// new query token per sequence attends over a static-length cache
// [B, S_max, Hkv, D] of which only the first lengths[b] rows are valid.
//
// Bound: HBM bytes. Each decode step must read the live K and V rows once,
// sum_b min(lengths[b], S_max) * Hkv * D * 2 * sizeof(T) bytes, and does
// about 4 flops per element read, far below the card's ~295 flops/byte
// balance point. The design reads each live byte once, keeps enough of
// them in flight to fill the card, and spreads a long row over many SMs:
//   - split-KV over a thread-block cluster: the grid is (splits, Hkv, B)
//     with cluster dims (splits, 1, 1), splits = min(8, ceil(S_max / 256))
//     (the portable cluster size), and rank r owns key positions
//     [r chunk, (r + 1) chunk), chunk = ceil(S_max / splits). A rank reads
//     lengths[b] on the device (no host sync) and loads only the live rows
//     of its chunk. A rank whose chunk starts at or past the length would
//     hold the empty partial (m = -1e30, l = 0, acc = 0), which adds
//     nothing to the merge: it exits at once (rank 0 stays, to write the
//     zeros of a row with lengths[b] == 0), so it holds no SM while its
//     peers work. A row of 954 live keys is walked by four SMs, not one;
//   - inside a rank, one thread streams tiles of R rows of K and V (R x D
//     boxes of a 4-D TMA map over (D, Hkv, S_max, B), at most 8 KB each)
//     through a two-stage mbarrier ring, refilling a stage as soon as the
//     CTA has read it. At the main path's shape (bf16, D = 128, group 1) a
//     CTA holds 33 KB of shared memory and 94 registers a thread, so five
//     CTAs share an SM with up to 160 KB of loads in flight. More CTAs
//     beat a deeper ring here: three stages (four CTAs an SM) or 16 KB
//     tiles were slower, and capping the registers for six or eight CTAs
//     an SM spilled and was slower still (PERF.md, PR 5);
//   - compute runs on CUDA cores from shared memory: "row groups" of tpr
//     threads each take one K/V row at a time with 16-byte loads, and keep
//     their own (m, l, acc) in fp32 registers (an online softmax), so no
//     [B, H, S_max] probability tensor is ever written. The CTA serves the
//     group = H / Hkv query heads that share the kv head, so each K/V byte
//     is read once for the whole group;
//   - merge: the row groups of a warp merge with shuffles, the warps of a
//     CTA in shared memory into the rank's partial (m, l, acc per head);
//     after cluster.sync() each live rank merges one slice of the group x
//     D outputs from every live rank's partial over distributed shared
//     memory, in rank order (the usual max-rescaled merge, so the sum
//     order is fixed and the result deterministic), and a second
//     cluster.sync() keeps each CTA's shared memory alive until its peers
//     have read it. One launch, no scratch in HBM.
//
// Semantics follow _ragged_ref (decode_attention.py:101-115): keys j <
// lengths[b] are attended, masked scores are -1e30, probabilities stay in
// fp32 before p.v, l is clamped to 1e-30, a row with lengths[b] == 0 is
// written as zeros (every partial is empty), the output is stored in q's
// dtype.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kSplitKeys = 256;    // key positions that earn one more rank
constexpr int kStages = 2;         // the ring of K/V tiles
constexpr int kStageBytes = 8192;  // at most, per K (and per V) tile
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

template <typename T>
struct VecIO;

template <>
struct VecIO<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static float from_float(float x) { return x; }
};

template <>
struct VecIO<__half> {
  static constexpr int N = 8;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ __forceinline__ static void load(const __half* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __half from_float(float x) {
    return __float2half_rn(x);
  }
};

template <>
struct VecIO<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Dynamic shared memory, from a 128-byte boundary: the ring of kStages K
// and V tiles (R x D each), which the warps' partials [kWarps][group] m, l
// and [kWarps][group][D] acc reuse once the ring is drained; then the
// rank's partial m[group], l[group], acc[group][D] that the cluster reads;
// then the ring's full barriers.
struct Layout {
  size_t part, bars, total;  // offsets from the base; the ring is at 0
  __host__ __device__ Layout(int group, int D, int tile_bytes) {
    const size_t tiles = (size_t)kStages * 2 * tile_bytes;
    const size_t warps = (size_t)kWarps * group * (D + 2) * 4;
    part = ((tiles > warps ? tiles : warps) + 15) & ~(size_t)15;
    bars = (part + (size_t)group * (D + 2) * 4 + 7) & ~(size_t)7;
    total = bars + 8 * kStages + 128;  // + the alignment of the base
  }
};

// G: compile-time bound on the query heads per kv head (group <= G).
// NV: 16-byte vectors per thread per row (2 only for fp32 rows wider than
// 32 vectors). U: K/V rows each row group takes per step.
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads)
    ragged_decode_split_kernel(const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const T* __restrict__ q,
                               const int* __restrict__ lengths,
                               T* __restrict__ out, int S, int H, int Hkv,
                               int D, int group, int tpr, int rows, int chunk,
                               float scale) {
  constexpr int VEC = VecIO<T>::N;
  constexpr int E = NV * VEC;  // elements of a row per thread
  constexpr int U = G >= 8 ? 2 : 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128);
  const int tile_bytes = rows * D * (int)sizeof(T);
  const Layout lay(group, D, tile_bytes);
  float* part_m = reinterpret_cast<float*>(smem + lay.part);
  float* part_l = part_m + group;
  float* part_acc = part_l + group;
  const uint32_t full0 = smem_u32(smem + lay.bars);
  const uint32_t ring0 = smem_u32(smem);

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % tpr;  // lane inside the row group
  const int rg_per_warp = 32 / tpr;
  const int n_rg = kWarps * rg_per_warp;  // row groups in the CTA
  const int rg = warp * rg_per_warp + lane / tpr;
  const int nvec = D / VEC;

  int n = lengths[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  // Ranks [0, live) hold live keys (rank 0 also for n == 0, to write the
  // zeros). A rank past them would contribute an empty partial: it leaves
  // at once and frees its SM. Peers neither read its shared memory nor
  // wait for it (a cluster barrier waits for the non-exited threads only).
  const int live = max(1, (n + chunk - 1) / chunk);
  if (rank >= live) return;
  const int c0 = rank * chunk;                 // this rank's key positions
  const int c1 = min(c0 + chunk, n);           // [c0, c1)
  const int ntiles = c1 > c0 ? (c1 - c0 + rows - 1) / rows : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(kStages, ntiles); ++i) {
      const uint32_t ks = ring0 + 2 * i * tile_bytes;
      mbar_expect_tx(full0 + 8 * i, 2 * tile_bytes);
      tma_load_4d(ks, &tk, full0 + 8 * i, 0, kvh, c0 + i * rows, b);
      tma_load_4d(ks + tile_bytes, &tv, full0 + 8 * i, 0, kvh, c0 + i * rows,
                  b);
    }
  }

  const int h0 = kvh * group;
  float qr[G][E];
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int iv = 0; iv < NV; ++iv) {
      const int vi = iv * tpr + sub;
      if (g < group && vi < nvec) {
        VecIO<T>::load(q + ((size_t)b * H + h0 + g) * D + vi * VEC,
                       &qr[g][iv * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[g][iv * VEC + e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][iv * VEC + e] = 0.f;
    }
  }
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < ntiles; ++i) {
    const Ring<kStages> ring(i);
    const T* ks = reinterpret_cast<const T*>(smem + (size_t)2 * ring.s *
                                                        tile_bytes);
    const T* vs = ks + rows * D;
    const int j0 = c0 + i * rows;  // the tile's first key position
    mbar_wait(full0 + 8 * ring.s, ring.phase);
    // The step bound is uniform across the CTA, so every lane of a warp
    // takes part in every shuffle; rows at or past c1 are masked to p = 0.
    for (int r0 = 0; r0 < rows; r0 += U * n_rg) {
      float kr[U][E], vr[U][E];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jt = r0 + u * n_rg + rg;
        ok[u] = jt < rows && j0 + jt < c1;
#pragma unroll
        for (int iv = 0; iv < NV; ++iv) {
          const int vi = iv * tpr + sub;
          if (ok[u] && vi < nvec) {
            VecIO<T>::load(ks + jt * D + vi * VEC, &kr[u][iv * VEC]);
            VecIO<T>::load(vs + jt * D + vi * VEC, &vr[u][iv * VEC]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              kr[u][iv * VEC + e] = 0.f;
              vr[u][iv * VEC + e] = 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[U];
        float mc = kNegInf;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
          for (int off = tpr >> 1; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          s[u] = ok[u] ? dot * scale : kNegInf;
          mc = fmaxf(mc, s[u]);
        }
        const float mn = fmaxf(m[g], mc);
        const float alpha = expf(m[g] - mn);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = ok[u] ? expf(s[u] - mn) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
        }
        m[g] = mn;
      }
    }
    __syncthreads();  // every thread has read the stage: refill it
    if (tid == 0 && i + kStages < ntiles) {
      const uint32_t ks_addr = ring0 + 2 * ring.s * tile_bytes;
      const int jn = c0 + (i + kStages) * rows;
      mbar_expect_tx(full0 + 8 * ring.s, 2 * tile_bytes);
      tma_load_4d(ks_addr, &tk, full0 + 8 * ring.s, 0, kvh, jn, b);
      tma_load_4d(ks_addr + tile_bytes, &tv, full0 + 8 * ring.s, 0, kvh, jn,
                  b);
    }
  }

  // Merge the row groups of this warp: lanes i and i ^ off (off >= tpr)
  // hold the same slice of D for two different row groups.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int off = tpr; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn);
      const float c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mn;
    }
  }

  // Merge the warps in shared memory (over the drained ring) into this
  // rank's partial.
  float* sm_m = reinterpret_cast<float*>(smem);
  float* sm_l = sm_m + kWarps * group;
  float* sm_acc = sm_l + kWarps * group;  // [kWarps][group][D]
  if (lane < tpr) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
      if (lane == 0) {
        sm_m[warp * group + g] = m[g];
        sm_l[warp * group + g] = l[g];
      }
#pragma unroll
      for (int iv = 0; iv < NV; ++iv) {
        const int vi = iv * tpr + sub;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            sm_acc[(warp * group + g) * D + vi * VEC + e] =
                acc[g][iv * VEC + e];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * group + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = expf(sm_m[w * group + g] - mx);
      lsum = fmaf(sm_l[w * group + g], sc, lsum);
      a = fmaf(sm_acc[w * group * D + i], sc, a);
    }
    part_acc[i] = a;
    if (i - g * D == 0) {
      part_m[g] = mx;
      part_l[g] = lsum;
    }
  }

  // Merge the ranks: rank r writes outputs [r per, (r + 1) per) of the
  // group's group x D, reading every live rank's partial in rank order.
  cluster.sync();
  const int total = group * D;
  const int per = (total + live - 1) / live;
  T* out_b = out + ((size_t)b * H + h0) * D;
  for (int i = rank * per + tid; i < min(total, (rank + 1) * per);
       i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
    for (int r = 0; r < live; ++r) {
      mx = fmaxf(mx, cluster.map_shared_rank(part_m, r)[g]);
    }
    float lsum = 0.f, a = 0.f;
    for (int r = 0; r < live; ++r) {
      const float* pm = cluster.map_shared_rank(part_m, r);
      const float sc = expf(pm[g] - mx);
      lsum = fmaf(pm[group + g], sc, lsum);      // part_l
      a = fmaf(pm[2 * group + i], sc, a);        // part_acc
    }
    out_b[i] = VecIO<T>::from_float(a / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

template <typename T, int G, int NV>
cudaError_t split_launch(const CUtensorMap& tk, const CUtensorMap& tv,
                         const void* q, const void* lengths, void* out, int B,
                         int S, int H, int Hkv, int D, int group, int tpr,
                         int rows, int splits, int chunk, float scale,
                         cudaStream_t stream) {
  auto kernel = ragged_decode_split_kernel<T, G, NV>;
  static bool done = false;
  // The largest layout any call of this instance can need.
  const cudaError_t e = allow_smem(
      kernel, Layout(G, kMaxD, kStageBytes).total, done);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      Layout(group, D, rows * D * (int)sizeof(T)).total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kernel, tk, tv, static_cast<const T*>(q),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, H, Hkv, D,
      group, tpr, rows, chunk, scale);
  return le != cudaSuccess ? le : cudaGetLastError();
}

template <typename T>
cudaError_t split_launch_dtype(const void* q, const void* k, const void* v,
                               const void* lengths, void* out, int B, int S,
                               int H, int Hkv, int D, float scale,
                               cudaStream_t stream) {
  constexpr int VEC = VecIO<T>::N;
  const int group = H / Hkv;
  const int nvec = D / VEC;
  int tpr = 1;
  while (tpr < nvec && tpr < 32) tpr <<= 1;
  const int nv = (nvec + tpr - 1) / tpr;
  const int gt = group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : 8;
  // Tiles of R rows, R a power of two in [8, 64] with R x D x sizeof(T) at
  // most kStageBytes (a multiple of 128 bytes, as TMA's destination needs).
  const int row_bytes = D * (int)sizeof(T);
  int rows = 64;
  while (rows > 8 && rows * row_bytes > kStageBytes) rows >>= 1;
  const int want = (S + kSplitKeys - 1) / kSplitKeys;
  const int splits = want < kMaxSplits ? want : kMaxSplits;
  const int chunk = (S + splits - 1) / splits;
  CUtensorMap tk, tv;
  if (!heads_map(&tk, k, VecIO<T>::kMap, sizeof(T), B, S, Hkv, D, D, rows,
                 CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !heads_map(&tv, v, VecIO<T>::kMap, sizeof(T), B, S, Hkv, D, D, rows,
                 CU_TENSOR_MAP_SWIZZLE_NONE) ||
      reinterpret_cast<uintptr_t>(q) % 16) {
    return cudaErrorInvalidValue;
  }
#define PT_LAUNCH(G_, NV_)                                                   \
  if (gt == G_ && nv == NV_)                                                 \
    return split_launch<T, G_, NV_>(tk, tv, q, lengths, out, B, S, H, Hkv,   \
                                    D, group, tpr, rows, splits, chunk,      \
                                    scale, stream);
  PT_LAUNCH(1, 1)
  PT_LAUNCH(2, 1)
  PT_LAUNCH(4, 1)
  PT_LAUNCH(8, 1)
  // Two vectors per thread only for fp32 rows wider than 32 vectors
  // (D > 128); a 16-bit row of D <= 256 is at most 32 vectors.
  if constexpr (VEC == 4) {
    PT_LAUNCH(1, 2)
    PT_LAUNCH(2, 2)
    PT_LAUNCH(4, 2)
    PT_LAUNCH(8, 2)
  }
#undef PT_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Pointers are device
// pointers to contiguous q [B, 1, H, D], caches [B, S, Hkv, D], lengths [B]
// int32 and out [B, 1, H, D]; every tensor must start on a 16-byte
// boundary (the caches are read with TMA). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int pt_ragged_decode_attention(const void* q, const void* k,
                                          const void* v, const void* lengths,
                                          void* out, int B, int S, int H,
                                          int Hkv, int D, float scale,
                                          int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > kMaxG || D <= 0 || D % 8 != 0 || D > kMaxD || B > 65535 ||
      Hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(split_launch_dtype<float>(
          q, k, v, lengths, out, B, S, H, Hkv, D, scale, st));
    case 1:
      return static_cast<int>(split_launch_dtype<__half>(
          q, k, v, lengths, out, B, S, H, Hkv, D, scale, st));
    case 2:
      return static_cast<int>(split_launch_dtype<__nv_bfloat16>(
          q, k, v, lengths, out, B, S, H, Hkv, D, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
