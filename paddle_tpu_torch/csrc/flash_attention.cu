// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K2 _fwd_kernel     (:47, via _fa_forward :88)      -> flash_fwd_wgmma_kernel
//   K3 _bwd_dq_kernel  (:129, via _flash_bwd_core :263) -> flash_bwd_dq_wgmma_kernel
//   K4 _bwd_dkv_kernel (:166, via _flash_bwd_core :263) -> flash_bwd_dkv_wgmma_kernel
// (the bfloat16 / float16 kernels at D <= 128, the training path; float32,
// and D up to 512 in any dtype, take the CUDA-core flash_*_kernel below;
// the wrapper pads D to a multiple of 8).
// q is [B, Sq, H, D], k and v are [B, Sk, Hkv, D], all contiguous and read
// in place by their strides (no transpose, no padding of S or D in memory).
// GQA maps q head h to kv head h / (H / Hkv).
//
// Bound: operations. At the training shape (B = 2, S = 2048, H = 32,
// D = 128, bf16, causal) K2 does 4 D flops per kept (query, key) pair, K3
// 6 D and K4 8 D: 0.0695 / 0.104 / 0.139 ms at 989 TFLOP/s, against
// 0.025-0.05 ms of bytes; hundreds of flops per byte.
//
// The Hopper kernels (K2, K3, K4). 384 threads: warpgroups 0 and 1 consume,
// warpgroup 2 produces (setmaxnreg gives the consumers 232 registers and
// leaves the producer 40). One producer thread issues every load with TMA
// from 4-D tensor maps over (D, heads, S, B) with 128-byte swizzle (boxes
// of 64 columns, so D = 128 is two boxes; rows and columns past S and D
// land as zeros). Tiles stream through a two-stage ring in shared memory:
// a full mbarrier per stage completes on the TMA bytes, an empty one on
// the 256 consumer threads. Products are wgmma with fp32 accumulators:
//   - K2: CTA = 128 q rows x (head, batch), each consumer warpgroup owns
//     64 rows. Q is loaded once; K and V tiles of 128 keys stream. S = Q K^T
//     is SS m64n128k16 (both K-major); the online softmax runs on the
//     accumulator registers with exp2f (scale folded with log2(e)); the
//     causal mask is applied only on tiles the top-left diagonal crosses,
//     the Sk mask only on the last tile; O += P V is RS (P packed to 16
//     bits, V MN-major through wgmma's transpose bit). q-blocks launch
//     longest causal rows first. 160 KB of shared memory at D = 128.
//   - K4: CTA = 64 keys x (kv head, batch); both consumer warpgroups own
//     its keys and split each q tile's work in two equal halves. K and V
//     are loaded once; Q and dO tiles of 64 rows stream with their LSE and
//     delta (1-D maps). Warpgroup 0: S^T = K Q^T (SS m64n64k16), P^T =
//     exp2(S^T scale log2(e) - LSE log2(e)) (kept in fp32 in shared
//     memory), dV += P^T dO (RS, dO MN-major). Warpgroup 1: dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta), dK += dS^T Q. A warpgroup that owned its
//     own 64 keys would hold dK, dV, S^T and dP^T at once (224 wgmma
//     registers a thread), more than ptxas keeps in a wgmma pipeline in a
//     384-thread CTA: it spilled and serialised every wgmma (measured:
//     264 bytes of spills, 0.53 ms). The CTA loops over the GQA group's
//     q heads itself and sums dK, dV in fp32 (rounded once); the causal
//     lower bound is the JAX rule (flash_attention.py:172), the mask only
//     on crossing tiles and the last q tile. 134 KB of shared memory at
//     D = 128.
//   - K3: CTA = 128 q rows x (head, batch), each consumer warpgroup owns
//     64 rows, as K2. Q and dO are loaded once; K and V tiles of 64 keys
//     stream, and each consumer reads its rows' LSE and delta once with
//     plain loads. Per tile, S = Q K^T and dP = dO V^T are SS m64n64k16
//     (both K-major, a commit group each), dS = P (dP - delta) with P =
//     exp2(S scale log2(e) - LSE log2(e)), masked as in K2, then dQ += dS K
//     is RS (dS packed to 16 bits, K MN-major through the transpose bit):
//     three batches of HGMMA a tile, one WARPGROUP.DEPBAR each. A thread
//     holds S, dP (32 registers each), dQ (64) and the dS fragments (16):
//     144, under the ~168 ptxas keeps spill-free in a 384-thread wgmma
//     pipeline (128-key tiles would need 192). 130 KB of shared memory at
//     D = 128.
//
// Common to all kernels:
//   - the [Sq, Sk] score matrix never leaves the CTA: the forward keeps an
//     online softmax (m, l, acc in fp32), the backward recomputes
//     P = exp(S - LSE) from the saved LSE;
//   - causal loops skip wholly masked blocks with the JAX bounds: hi for
//     K2/K3 (flash_attention.py:53-57, :137-141), lo for K4 (:172);
//   - K4 serves one kv head and loops over the group's q heads itself, so
//     GQA needs no repeated K/V and the group sum stays in fp32.
//
// Semantics kept from the Pallas kernels: masked scores are -1e30 (not
// -inf), l is clamped to 1e-30, the causal mask is top-left (qid >= kid),
// P is rounded to v's dtype before P.V and dS to q's dtype before its
// products (on the tensor cores: the packing of the fp32 accumulator into
// the next product's A fragment), outputs are stored in the input dtype,
// LSE in fp32 in natural-log units. delta = rowsum(dO * O) is computed
// outside the kernels, in fp32, by the wrapper.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 row lanes x 16 column lanes
constexpr float kNegInf = -1e30f;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  static constexpr int PAD = 1;  // shared-memory row pitch is DT + PAD
  __device__ __forceinline__ static float f(float x) { return x; }
  __device__ __forceinline__ static float to(float x) { return x; }
  __device__ __forceinline__ static float round(float x) { return x; }
};

template <>
struct Cvt<__half> {
  static constexpr int VEC = 8;
  static constexpr int PAD = 2;
  __device__ __forceinline__ static float f(__half x) {
    return __half2float(x);
  }
  __device__ __forceinline__ static __half to(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int PAD = 2;
  __device__ __forceinline__ static float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 to(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// Rows [r0, r0 + R) of one head of a [S, heads, D] slab (row_stride =
// heads * D) into a shared tile [R][DT + PAD]; rows >= S and columns >= D
// are zero, so padded K/V rows add nothing (0 * value, never 0 * NaN).
template <typename T, int R, int DT>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src, int r0,
                                          int S, size_t row_stride, int D) {
  constexpr int VEC = Cvt<T>::VEC;
  constexpr int P = DT + Cvt<T>::PAD;
  constexpr int NV = DT / VEC;
  for (int idx = threadIdx.x; idx < R * NV; idx += kThreads) {
    const int r = idx / NV;
    const int c = (idx - r * NV) * VEC;
    T* out = dst + r * P + c;
    if (r0 + r < S && c < D) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * row_stride + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = e[i];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = Cvt<T>::to(0.f);
    }
  }
}

// Max / sum over the 16 lanes of a row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// ---------------------------------------------------------------------------
// K2: forward. One CTA per (q-block of BR rows, head, batch).
// ---------------------------------------------------------------------------
template <typename T, int DT, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                     int D, float scale, int causal) {
  constexpr int P = DT + Cvt<T>::PAD;
  constexpr int PS = BC + 1;
  constexpr int RR = BR / 16, CC = BC / 16, CD = DT / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BR * P;
  T* Vs = Ks + BC * P;
  float* Ps = reinterpret_cast<float*>(Vs + BC * P);

  const int nq = (Sq + BR - 1) / BR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BR;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qrs = (size_t)H * D, krs = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * qrs + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * krs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * krs + (size_t)kvh * D;

  load_tile<T, BR, DT>(Qs, qb, q0, Sq, qrs, D);

  float m[RR], l[RR], acc[RR][CD];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) acc[rr][cd] = 0.f;
  }

  const int nk = (Sk + BC - 1) / BC;
  const int hi = causal ? min(nk, (q0 + BR + BC - 1) / BC) : nk;
  for (int ik = 0; ik < hi; ++ik) {
    const int k0 = ik * BC;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, BC, DT>(Ks, kb, k0, Sk, krs, D);
    load_tile<T, BC, DT>(Vs, vb, k0, Sk, krs, D);
    __syncthreads();

    float s[RR][CC];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) s[rr][cc] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RR], kv[CC];
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        qv[rr] = Cvt<T>::f(Qs[(ty + 16 * rr) * P + d]);
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        kv[cc] = Cvt<T>::f(Ks[(tx + 16 * cc) * P + d]);
      }
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          s[rr][cc] = fmaf(qv[rr], kv[cc], s[rr][cc]);
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int qi = q0 + ty + 16 * rr;
      float mx = kNegInf;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int kj = k0 + tx + 16 * cc;
        const bool ok = kj < Sk && (!causal || qi >= kj);
        s[rr][cc] = ok ? s[rr][cc] * scale : kNegInf;
        mx = fmaxf(mx, s[rr][cc]);
      }
      const float mn = fmaxf(m[rr], row_max(mx));
      const float alpha = expf(m[rr] - mn);
      float ps = 0.f;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float p = expf(s[rr][cc] - mn);
        ps += p;
        Ps[(ty + 16 * rr) * PS + tx + 16 * cc] = Cvt<T>::round(p);
      }
      l[rr] = l[rr] * alpha + row_sum(ps);
      m[rr] = mn;
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) acc[rr][cd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BC; ++j) {
      float pv[RR], vv[CD];
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) pv[rr] = Ps[(ty + 16 * rr) * PS + j];
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) {
        vv[cd] = Cvt<T>::f(Vs[j * P + tx + 16 * cd]);
      }
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) {
          acc[rr][cd] = fmaf(pv[rr], vv[cd], acc[rr][cd]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    const int qi = q0 + ty + 16 * rr;
    if (qi >= Sq) continue;
    const float ll = fmaxf(l[rr], 1e-30f);
    T* orow = o + ((size_t)b * Sq + qi) * qrs + (size_t)h * D;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) orow[d] = Cvt<T>::to(acc[rr][cd] / ll);
    }
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qi] = m[rr] + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// K3: backward dQ. One CTA per (q-block of BR rows, head, batch):
//   dQ = scale * sum_k (P o (dO V^T - delta)) K,  P = exp(S - LSE).
// ---------------------------------------------------------------------------
template <typename T, int DT, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int H, int Hkv, int D, float scale,
                        int causal) {
  constexpr int P = DT + Cvt<T>::PAD;
  constexpr int PS = BC + 1;
  constexpr int RR = BR / 16, CC = BC / 16, CD = DT / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BR * P;
  T* Ks = dOs + BR * P;
  T* Vs = Ks + BC * P;
  float* dSs = reinterpret_cast<float*>(Vs + BC * P);

  const int nq = (Sq + BR - 1) / BR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qrs = (size_t)H * D, krs = (size_t)Hkv * D;
  const size_t qoff = (size_t)b * Sq * qrs + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * krs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * krs + (size_t)kvh * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * Sq;
  const float* delta_bh = delta + ((size_t)b * H + h) * Sq;

  load_tile<T, BR, DT>(Qs, q + qoff, q0, Sq, qrs, D);
  load_tile<T, BR, DT>(dOs, dout + qoff, q0, Sq, qrs, D);

  float lse_r[RR], delta_r[RR], acc[RR][CD];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    const int qi = q0 + ty + 16 * rr;
    lse_r[rr] = qi < Sq ? lse_bh[qi] : 0.f;
    delta_r[rr] = qi < Sq ? delta_bh[qi] : 0.f;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) acc[rr][cd] = 0.f;
  }

  const int nk = (Sk + BC - 1) / BC;
  const int hi = causal ? min(nk, (q0 + BR + BC - 1) / BC) : nk;
  for (int ik = 0; ik < hi; ++ik) {
    const int k0 = ik * BC;
    __syncthreads();
    load_tile<T, BC, DT>(Ks, kb, k0, Sk, krs, D);
    load_tile<T, BC, DT>(Vs, vb, k0, Sk, krs, D);
    __syncthreads();

    float s[RR][CC], dp[RR][CC];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) s[rr][cc] = dp[rr][cc] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RR], ov[RR], kv[CC], vv[CC];
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        qv[rr] = Cvt<T>::f(Qs[(ty + 16 * rr) * P + d]);
        ov[rr] = Cvt<T>::f(dOs[(ty + 16 * rr) * P + d]);
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        kv[cc] = Cvt<T>::f(Ks[(tx + 16 * cc) * P + d]);
        vv[cc] = Cvt<T>::f(Vs[(tx + 16 * cc) * P + d]);
      }
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          s[rr][cc] = fmaf(qv[rr], kv[cc], s[rr][cc]);
          dp[rr][cc] = fmaf(ov[rr], vv[cc], dp[rr][cc]);
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int qi = q0 + ty + 16 * rr;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int kj = k0 + tx + 16 * cc;
        const bool ok = kj < Sk && (!causal || qi >= kj);
        const float x = ok ? s[rr][cc] * scale : kNegInf;
        const float p = expf(x - lse_r[rr]);
        dSs[(ty + 16 * rr) * PS + tx + 16 * cc] =
            Cvt<T>::round(p * (dp[rr][cc] - delta_r[rr]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BC; ++j) {
      float dsv[RR], kv[CD];
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) dsv[rr] = dSs[(ty + 16 * rr) * PS + j];
#pragma unroll
      for (int cd = 0; cd < CD; ++cd) {
        kv[cd] = Cvt<T>::f(Ks[j * P + tx + 16 * cd]);
      }
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) {
          acc[rr][cd] = fmaf(dsv[rr], kv[cd], acc[rr][cd]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    const int qi = q0 + ty + 16 * rr;
    if (qi >= Sq) continue;
    T* row = dq + ((size_t)b * Sq + qi) * qrs + (size_t)h * D;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) row[d] = Cvt<T>::to(scale * acc[rr][cd]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: backward dK, dV. One CTA per (k-block of BR rows, kv head, batch),
// looping over the group's q heads and, per head, over the q-blocks of BC
// rows from the causal lower bound:
//   dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q,  dS = P o (dO V^T - delta).
// ---------------------------------------------------------------------------
template <typename T, int DT, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                         int D, float scale, int causal) {
  constexpr int P = DT + Cvt<T>::PAD;
  constexpr int PS = BC + 1;
  constexpr int RR = BR / 16, CC = BC / 16, CD = DT / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BR * P;
  T* Qs = Vs + BR * P;
  T* dOs = Qs + BC * P;
  float* Ps = reinterpret_cast<float*>(dOs + BC * P);
  float* dSs = Ps + BR * PS;
  float* lse_s = dSs + BR * PS;
  float* delta_s = lse_s + BC;

  const int k0 = blockIdx.x * BR;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qrs = (size_t)H * D, krs = (size_t)Hkv * D;
  const size_t koff = (size_t)b * Sk * krs + (size_t)kvh * D;

  load_tile<T, BR, DT>(Ks, k + koff, k0, Sk, krs, D);
  load_tile<T, BR, DT>(Vs, v + koff, k0, Sk, krs, D);

  float dka[RR][CD], dva[RR][CD];
#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) dka[rr][cd] = dva[rr][cd] = 0.f;
  }

  const int nq = (Sq + BC - 1) / BC;
  const int lo = causal ? k0 / BC : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t qoff = (size_t)b * Sq * qrs + (size_t)h * D;
    const float* lse_bh = lse + ((size_t)b * H + h) * Sq;
    const float* delta_bh = delta + ((size_t)b * H + h) * Sq;
    for (int iq = lo; iq < nq; ++iq) {
      const int q0 = iq * BC;
      __syncthreads();
      load_tile<T, BC, DT>(Qs, q + qoff, q0, Sq, qrs, D);
      load_tile<T, BC, DT>(dOs, dout + qoff, q0, Sq, qrs, D);
      for (int i = threadIdx.x; i < BC; i += kThreads) {
        lse_s[i] = q0 + i < Sq ? lse_bh[q0 + i] : 0.f;
        delta_s[i] = q0 + i < Sq ? delta_bh[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows are this CTA's keys, columns the block's queries.
      float s[RR][CC], dp[RR][CC];
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) s[rr][cc] = dp[rr][cc] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RR], vv[RR], qv[CC], ov[CC];
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
          kv[rr] = Cvt<T>::f(Ks[(ty + 16 * rr) * P + d]);
          vv[rr] = Cvt<T>::f(Vs[(ty + 16 * rr) * P + d]);
        }
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          qv[cc] = Cvt<T>::f(Qs[(tx + 16 * cc) * P + d]);
          ov[cc] = Cvt<T>::f(dOs[(tx + 16 * cc) * P + d]);
        }
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) {
            s[rr][cc] = fmaf(kv[rr], qv[cc], s[rr][cc]);
            dp[rr][cc] = fmaf(vv[rr], ov[cc], dp[rr][cc]);
          }
        }
      }

#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        const int kj = k0 + ty + 16 * rr;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const int c = tx + 16 * cc;
          const int qi = q0 + c;
          const bool ok = qi < Sq && (!causal || qi >= kj);
          const float x = ok ? s[rr][cc] * scale : kNegInf;
          const float p = expf(x - lse_s[c]);
          Ps[(ty + 16 * rr) * PS + c] = Cvt<T>::round(p);
          dSs[(ty + 16 * rr) * PS + c] =
              Cvt<T>::round(p * (dp[rr][cc] - delta_s[c]));
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < BC; ++i) {
        float pv[RR], dsv[RR], ov[CD], qv[CD];
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
          pv[rr] = Ps[(ty + 16 * rr) * PS + i];
          dsv[rr] = dSs[(ty + 16 * rr) * PS + i];
        }
#pragma unroll
        for (int cd = 0; cd < CD; ++cd) {
          ov[cd] = Cvt<T>::f(dOs[i * P + tx + 16 * cd]);
          qv[cd] = Cvt<T>::f(Qs[i * P + tx + 16 * cd]);
        }
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
          for (int cd = 0; cd < CD; ++cd) {
            dva[rr][cd] = fmaf(pv[rr], ov[cd], dva[rr][cd]);
            dka[rr][cd] = fmaf(dsv[rr], qv[cd], dka[rr][cd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RR; ++rr) {
    const int kj = k0 + ty + 16 * rr;
    if (kj >= Sk) continue;
    const size_t off = ((size_t)b * Sk + kj) * krs + (size_t)kvh * D;
#pragma unroll
    for (int cd = 0; cd < CD; ++cd) {
      const int d = tx + 16 * cd;
      if (d < D) {
        dk[off + d] = Cvt<T>::to(scale * dka[rr][cd]);
        dv[off + d] = Cvt<T>::to(dva[rr][cd]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper kernels for bfloat16 and float16 at D <= 128: K2, K3 and K4 (design
// in the head comment; tile and fragment layouts in wgmma.cuh).
// ---------------------------------------------------------------------------
constexpr int kWsThreads = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumers = 256;
constexpr int kFwdStages = 2;     // K2's ring of K/V tiles
constexpr int kDqKeys = 64;       // K3's key tile
constexpr int kDqStages = 2;      // K3's ring of K/V tiles
constexpr int kDkvKeys = 64;      // K4's keys per CTA
constexpr int kDkvQRows = 64;     // K4's q tile
constexpr int kDkvStages = 2;     // K4's ring of Q/dO tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Max / sum over the quad of lanes that share a row of a fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K2 on Hopper. CTA = 128 q rows x (head, batch); key tiles of 128.
// Shared memory: Q (BR x DT), then S stages of K and V (BC x DT each),
// then the barriers: Q's, full[S], empty[S].
template <typename T, int DT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           T* __restrict__ o, float* __restrict__ lse, int Sq,
                           int Sk, int H, int Hkv, int D, float scale,
                           int causal) {
  constexpr int BR = 128, BC = 128, NH = DT / 64;
  constexpr uint32_t QB = BR * DT * 2, KB = BC * DT * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  constexpr int S = kFwdStages;
  const uint32_t bars = sq + QB + 2 * S * KB;
  const uint32_t qbar = bars, full0 = bars + 8, empty0 = full0 + 8 * S;

  const int nq = (Sq + BR - 1) / BR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BR;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int nk = (Sk + BC - 1) / BC;
  const int hi = causal ? min(nk, (q0 + BR + BC - 1) / BC) : nk;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(qbar, QB);
      for (int c = 0; c < NH; ++c) {
        tma_load_4d(sq + c * (BR * 128), &tq, qbar, c * 64, h, q0, b);
      }
      for (int i = 0; i < hi; ++i) {
        const Ring<S> r(i);
        const uint32_t full = full0 + 8 * r.s;
        const uint32_t ks = sq + QB + 2 * r.s * KB, vs = ks + KB;
        mbar_wait(empty0 + 8 * r.s, r.phase ^ 1);
        mbar_expect_tx(full, 2 * KB);
        for (int c = 0; c < NH; ++c) {
          tma_load_4d(ks + c * (BC * 128), &tk, full, c * 64, kvh, i * BC, b);
          tma_load_4d(vs + c * (BC * 128), &tv, full, c * 64, kvh, i * BC, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [qw, qw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw = q0 + wg * 64;
    const int r0 = qw + warp * 16 + g;  // this lane's rows: r0 and r0 + 8
    const float sl2 = scale * kLog2e;   // scores in log2 units
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) acc[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < hi; ++i) {
      const Ring<S> ring(i);
      const int k0 = i * BC;
      const uint32_t ks = sq + QB + 2 * ring.s * KB, vs = ks + KB;
      mbar_wait(full0 + 8 * ring.s, ring.phase);

      float sc[BC / 2];
#pragma unroll
      for (int j = 0; j < BC / 2; ++j) sc[j] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk >> 2) * (BR * 128) + (kk & 3) * 32;
        wg_ss<T, BC>(sc, sw128_desc(sq + off + wg * 64 * 128, 16),
                     sw128_desc(ks + off, 16));
      }
      wg_commit_wait();
      wg_hold<BC / 2>(sc);

      // Masks only where the tile crosses the top-left diagonal or Sk.
      const bool edge = k0 + BC > Sk || (causal && k0 + BC - 1 > qw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sl2;
          if (edge) {
            const int qi = r0 + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (kj >= Sk || (causal && qi < kj)) x = kNegInf;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2f(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = exp2f(sc[4 * j + e] - m[e >> 1]);
          ps[e >> 1] += sc[4 * j + e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(ps[r]);
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[BC / 16][4];
      pack_a<T, BC / 8>(pa, sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        wg_rs<T, DT>(acc, pa[kk], sw128_desc(vs + kk * 16 * 128, BC * 128));
      }
      wg_commit_wait();
      wg_hold<DT / 2>(acc);
      wg_hold<BC / 16>(pa);
      mbar_arrive(empty0 + 8 * ring.s);
    }

    const size_t qrs = (size_t)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + r * 8;
      if (qi >= Sq) continue;
      const float ll = fmaxf(l[r], 1e-30f);
      T* orow = o + ((size_t)b * Sq + qi) * qrs + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<uint32_t*>(orow + d) = pack2<T>(
              acc[4 * j + 2 * r] / ll, acc[4 * j + 2 * r + 1] / ll);
        }
      }
      if (t == 0) lse[((size_t)b * H + h) * Sq + qi] = m[r] * kLn2 + logf(ll);
    }
  }
}

// K3 on Hopper. CTA = 128 q rows x (head, batch); key tiles of 64. Each
// consumer warpgroup owns 64 rows: S = Q K^T and dP = dO V^T (SS), dS =
// P (dP - delta) with P = exp2(S scale log2(e) - LSE log2(e)), then
// dQ += dS K (RS, dS packed to 16 bits, K MN-major).
// Shared memory: Q and dO (BR x DT each), then S stages of K and V (BC x DT
// each), then the barriers: Q/dO's, full[S], empty[S].
template <typename T, int DT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq, int Sq, int Sk, int H,
                              int Hkv, int D, float scale, int causal) {
  constexpr int BR = 128, BC = kDqKeys, NH = DT / 64;
  constexpr uint32_t QB = BR * DT * 2, KB = BC * DT * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u, sdo = sq + QB;
  constexpr int S = kDqStages;
  const uint32_t ring0 = sdo + QB;
  const uint32_t bars = ring0 + 2 * S * KB;
  const uint32_t qbar = bars, full0 = bars + 8, empty0 = full0 + 8 * S;

  const int nq = (Sq + BR - 1) / BR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BR;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int nk = (Sk + BC - 1) / BC;
  const int hi = causal ? min(nk, (q0 + BR + BC - 1) / BC) : nk;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(qbar, 2 * QB);
      for (int c = 0; c < NH; ++c) {
        tma_load_4d(sq + c * (BR * 128), &tq, qbar, c * 64, h, q0, b);
        tma_load_4d(sdo + c * (BR * 128), &tdo, qbar, c * 64, h, q0, b);
      }
      for (int i = 0; i < hi; ++i) {
        const Ring<S> r(i);
        const uint32_t full = full0 + 8 * r.s;
        const uint32_t ks = ring0 + 2 * r.s * KB, vs = ks + KB;
        mbar_wait(empty0 + 8 * r.s, r.phase ^ 1);
        mbar_expect_tx(full, 2 * KB);
        for (int c = 0; c < NH; ++c) {
          tma_load_4d(ks + c * (BC * 128), &tk, full, c * 64, kvh, i * BC, b);
          tma_load_4d(vs + c * (BC * 128), &tv, full, c * 64, kvh, i * BC, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows [qw, qw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw = q0 + wg * 64;
    const int r0 = qw + warp * 16 + g;  // this lane's rows: r0 and r0 + 8
    const float sl2 = scale * kLog2e;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + r * 8;
      const size_t row = ((size_t)b * H + h) * Sq + qi;
      lse2[r] = qi < Sq ? lse[row] * kLog2e : 0.f;
      dl[r] = qi < Sq ? delta[row] : 0.f;
    }
    float acc[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) acc[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < hi; ++i) {
      const Ring<S> ring(i);
      const int k0 = i * BC;
      const uint32_t ks = ring0 + 2 * ring.s * KB, vs = ks + KB;
      mbar_wait(full0 + 8 * ring.s, ring.phase);

      // S, then dP, in two commit groups (in one, ptxas injects a wait
      // between them, C7517/C7519). No branch around the products: one
      // that skipped a tile wholly past the warpgroup's rows made ptxas
      // serialise every wgmma (C7520), so such a tile is masked to zero.
      float sc[BC / 2], dp[BC / 2];
#pragma unroll
      for (int j = 0; j < BC / 2; ++j) sc[j] = dp[j] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk >> 2) * (BR * 128) + (kk & 3) * 32 +
                             wg * 64 * 128;
        const uint32_t koff = (kk >> 2) * (BC * 128) + (kk & 3) * 32;
        wg_ss<T, BC>(sc, sw128_desc(sq + off, 16), sw128_desc(ks + koff, 16));
      }
      wg_commit_wait();
      wg_hold<BC / 2>(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk >> 2) * (BR * 128) + (kk & 3) * 32 +
                             wg * 64 * 128;
        const uint32_t koff = (kk >> 2) * (BC * 128) + (kk & 3) * 32;
        wg_ss<T, BC>(dp, sw128_desc(sdo + off, 16), sw128_desc(vs + koff, 16));
      }
      wg_commit_wait();
      wg_hold<BC / 2>(dp);

      // Masks only where the tile crosses the top-left diagonal or Sk.
      const bool edge = k0 + BC > Sk || (causal && k0 + BC - 1 > qw);
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[4 * j + e], sl2, -lse2[e >> 1]));
          if (edge) {
            const int qi = r0 + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (kj >= Sk || (causal && qi < kj)) p = 0.f;
          }
          sc[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);  // dS
        }
      }
      // dQ += dS K, dS rounded to q's dtype as A fragments.
      uint32_t pa[BC / 16][4];
      pack_a<T, BC / 8>(pa, sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        wg_rs<T, DT>(acc, pa[kk], sw128_desc(ks + kk * 16 * 128, BC * 128));
      }
      wg_commit_wait();
      wg_hold<DT / 2>(acc);
      wg_hold<BC / 16>(pa);
      mbar_arrive(empty0 + 8 * ring.s);
    }

    const size_t qrs = (size_t)H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + r * 8;
      if (qi >= Sq) continue;
      T* row = dq + ((size_t)b * Sq + qi) * qrs + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<uint32_t*>(row + d) = pack2<T>(
              scale * acc[4 * j + 2 * r], scale * acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// K4 on Hopper. CTA = 64 keys x (kv head, batch); q tiles of 64 rows. Both
// consumer warpgroups own the CTA's 64 keys and split the work of a tile
// in two halves of equal size: warpgroup 0 computes S^T = K Q^T, P^T and
// dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, dS^T = P^T (dP^T -
// delta) with warpgroup 0's fp32 P^T read back from shared memory, and
// dK += dS^T Q. Each thread then holds one 64 x 128 fp32 accumulator, not
// two: the four accumulators of a thread that owns both (224 registers
// with P^T and dS^T) exceed what ptxas lets a wgmma pipeline hold in a
// 384-thread CTA, and it spills and serialises them.
// Shared memory: K and V (BK x DT each), then S stages of Q, dO (BQ x DT
// each), LSE and delta (BQ + 4 floats each, from the 16-byte boundary at or
// before the tile's first row: a TMA box starts on one), padded to 1 KB;
// a P^T (fp32, element-major over the warpgroup's 128 threads) for each
// stage; then the barriers: K/V's, full[S], empty[S], P^T's full[S].
template <typename T, int DT>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tlse,
                               const __grid_constant__ CUtensorMap tdelta,
                               T* __restrict__ dk, T* __restrict__ dv, int Sq,
                               int Sk, int H, int Hkv, int D, float scale,
                               int causal) {
  constexpr int BK = kDkvKeys, BQ = kDkvQRows, NH = DT / 64, NS = BQ + 4;
  constexpr uint32_t KB = BK * DT * 2, QB = BQ * DT * 2;
  constexpr uint32_t STAGE = 2 * QB + 1024;  // Q, dO, LSE, delta
  constexpr uint32_t PB = BK * BQ * 4;       // P^T of one tile, fp32
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sk = (smem_u32(smem) + 1023) & ~1023u, sv = sk + KB;
  constexpr int S = kDkvStages;
  const uint32_t stage0 = sk + 2 * KB, p0 = stage0 + S * STAGE;
  const uint32_t bars = p0 + S * PB;
  const uint32_t kvbar = bars, full0 = bars + 8, empty0 = full0 + 8 * S;
  const uint32_t pfull0 = empty0 + 8 * S;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int nq = (Sq + BQ - 1) / BQ;
  const int lo = causal ? min(k0 / BQ, nq) : 0;
  const int per_head = nq - lo, n = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
      mbar_init(pfull0 + 8 * s, kConsumers / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(kvbar, 2 * KB);
      for (int c = 0; c < NH; ++c) {
        tma_load_4d(sk + c * (BK * 128), &tk, kvbar, c * 64, kvh, k0, b);
        tma_load_4d(sv + c * (BK * 128), &tv, kvbar, c * 64, kvh, k0, b);
      }
      for (int it = 0; it < n; ++it) {
        const int gi = it / per_head, q0 = (lo + it - gi * per_head) * BQ;
        const int h = kvh * group + gi;
        const Ring<S> r(it);
        const uint32_t full = full0 + 8 * r.s, st = stage0 + r.s * STAGE;
        mbar_wait(empty0 + 8 * r.s, r.phase ^ 1);
        mbar_expect_tx(full, 2 * QB + 2 * NS * 4);
        for (int c = 0; c < NH; ++c) {
          tma_load_4d(st + c * (BQ * 128), &tq, full, c * 64, h, q0, b);
          tma_load_4d(st + QB + c * (BQ * 128), &tdo, full, c * 64, h, q0, b);
        }
        const int row = ((b * H + h) * Sq + q0) & ~3;
        tma_load_1d(st + 2 * QB, &tlse, full, row);
        tma_load_1d(st + 2 * QB + 512, &tdelta, full, row);
      }
    }
  } else {  // consumers: both own keys [k0, k0 + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int j0 = k0 + warp * 16 + g;  // this lane's keys: j0 and j0 + 8
    const float sl2 = scale * kLog2e;
    const uint32_t smem0 = smem_u32(smem);
    // The A operand of the warpgroup's first product: K (warpgroup 0) or
    // V (1); the B operands of its two products: Q and dO, or dO and Q.
    const uint32_t sa = wg == 0 ? sk : sv;
    const uint32_t b1 = wg == 0 ? 0 : QB, b2 = wg == 0 ? QB : 0;
    float acc[DT / 2];  // dV (warpgroup 0) or dK (1)
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) acc[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int it = 0; it < n; ++it) {
      const int gi = it / per_head, q0 = (lo + it - gi * per_head) * BQ;
      const int h = kvh * group + gi;
      const Ring<S> ring(it);
      const int s = ring.s;
      const uint32_t st = stage0 + s * STAGE;
      float* pt = reinterpret_cast<float*>(smem + (p0 + s * PB - smem0)) + tid;
      mbar_wait(full0 + 8 * s, ring.phase);

      // S^T (warpgroup 0) or dP^T (1): rows are the keys, columns the
      // tile's queries.
      float sc[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) sc[j] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wg_ss<T, BQ>(sc, sw128_desc(sa + (kk >> 2) * (BK * 128) + off, 16),
                     sw128_desc(st + b1 + (kk >> 2) * (BQ * 128) + off, 16));
      }
      wg_commit_wait();
      wg_hold<BQ / 2>(sc);

      const float* ls =
          reinterpret_cast<const float*>(smem + (st + 2 * QB - smem0)) +
          (((b * H + h) * Sq + q0) & 3);
      if (wg == 0) {
        // P^T = exp2(S^T scale log2(e) - LSE log2(e)), masked where the
        // tile crosses the top-left diagonal or Sq; kept for warpgroup 1.
        const bool edge = q0 + BQ > Sq || (causal && q0 < k0 + BK - 1);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + 2 * t + (e & 1);
            float p = exp2f(fmaf(sc[4 * j + e], sl2, -ls[c] * kLog2e));
            if (edge) {
              const int qi = q0 + c, kj = j0 + (e >> 1) * 8;
              if (qi >= Sq || (causal && qi < kj)) p = 0.f;
            }
            sc[4 * j + e] = p;
            pt[(4 * j + e) * 128] = p;
          }
        }
        mbar_arrive(pfull0 + 8 * s);
      } else {
        // dS^T = P^T (dP^T - delta).
        const float* dl = ls + 128;
        mbar_wait(pfull0 + 8 * s, ring.phase);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + 2 * t + (e & 1);
            sc[4 * j + e] = pt[(4 * j + e) * 128] * (sc[4 * j + e] - dl[c]);
          }
        }
      }
      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1), P^T and dS^T
      // rounded to the input dtype as A fragments.
      uint32_t pa[BQ / 16][4];
      pack_a<T, BQ / 8>(pa, sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wg_rs<T, DT>(acc, pa[kk],
                     sw128_desc(st + b2 + kk * 16 * 128, BQ * 128));
      }
      wg_commit_wait();
      wg_hold<DT / 2>(acc);
      wg_hold<BQ / 16>(pa);
      mbar_arrive(empty0 + 8 * s);
    }

    T* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
    const size_t krs = (size_t)Hkv * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = j0 + r * 8;
      if (kj >= Sk) continue;
      T* row = out + ((size_t)b * Sk + kj) * krs + (size_t)kvh * D;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<uint32_t*>(row + d) = pack2<T>(
              mul * acc[4 * j + 2 * r], mul * acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers. DT (the padded head width in shared memory) is 64, 128, 256 or
// 512. The CUDA-core kernels take tiles of 64 x 64 up to DT = 128, 32 x 32
// at DT = 256 and 16 x 16 at DT = 512, which keeps the per-thread
// accumulators at 64 floats or fewer and shared memory under the 227 KB a
// CTA may use (fp32 K4 at DT = 128: 166 KB, at DT = 512: 133 KB); the
// Hopper kernels' tiles are fixed in their kernels.
// ---------------------------------------------------------------------------
struct Shape {
  int B, Sq, Sk, H, Hkv, D, causal;
  float scale;
};

template <typename T, int DT, int BR, int BC>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Shape& s, cudaStream_t st) {
  constexpr int P = DT + Cvt<T>::PAD;
  constexpr size_t smem = (size_t)(BR + 2 * BC) * P * sizeof(T) +
                          (size_t)BR * (BC + 1) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DT, BR, BC>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sq + BR - 1) / BR, s.H, s.B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s.Sq, s.Sk, s.H, s.Hkv, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DT, int BR, int BC>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const Shape& s, cudaStream_t st) {
  constexpr int P = DT + Cvt<T>::PAD;
  constexpr size_t smem = (size_t)(2 * BR + 2 * BC) * P * sizeof(T) +
                          (size_t)BR * (BC + 1) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, DT, BR, BC>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sq + BR - 1) / BR, s.H, s.B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s.Sq, s.Sk, s.H, s.Hkv, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DT, int BR, int BC>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const Shape& s, cudaStream_t st) {
  constexpr int P = DT + Cvt<T>::PAD;
  constexpr size_t smem = (size_t)(2 * BR + 2 * BC) * P * sizeof(T) +
                          (size_t)(2 * BR * (BC + 1) + 2 * BC) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, DT, BR, BC>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sk + BR - 1) / BR, s.Hkv, s.B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s.Sq, s.Sk, s.H, s.Hkv, s.D,
      s.scale, s.causal);
  return cudaGetLastError();
}

// A [B, S, heads, D] 16-bit tensor as a 4-D map (heads_map, tma.cuh) with
// boxes of 64 columns x `rows` rows of one head and 128-byte swizzle.
template <typename T>
bool rows_map(CUtensorMap* m, const void* p, int B, int S, int heads, int D,
              int rows) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return heads_map(m, p, type, 2, B, S, heads, D, 64, rows,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// A flat fp32 [n] array (LSE or delta, [B, H, Sq]) as a 1-D map, boxes of
// `rows` values.
bool stats_map(CUtensorMap* m, const void* p, size_t n, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)rows}, unit[1] = {1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(p),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DT>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                      void* lse, const Shape& s, cudaStream_t st) {
  constexpr size_t smem = 1024 + (size_t)(1 + 2 * kFwdStages) * 128 * DT * 2 +
                          8 * (1 + 2 * kFwdStages);
  CUtensorMap tq, tk, tv;
  if (!rows_map<T>(&tq, q, s.B, s.Sq, s.H, s.D, 128) ||
      !rows_map<T>(&tk, k, s.B, s.Sk, s.Hkv, s.D, 128) ||
      !rows_map<T>(&tv, v, s.B, s.Sk, s.Hkv, s.D, 128)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_wgmma_kernel<T, DT>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sq + 127) / 128, s.H, s.B);
  kernel<<<grid, kWsThreads, smem, st>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), s.Sq, s.Sk,
      s.H, s.Hkv, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t bwd_dq_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, const Shape& s, cudaStream_t st) {
  constexpr size_t smem = 1024 + (size_t)2 * 128 * DT * 2 +
                          (size_t)2 * kDqStages * kDqKeys * DT * 2 +
                          8 * (1 + 2 * kDqStages);
  CUtensorMap tq, tk, tv, tdo;
  if (!rows_map<T>(&tq, q, s.B, s.Sq, s.H, s.D, 128) ||
      !rows_map<T>(&tdo, dout, s.B, s.Sq, s.H, s.D, 128) ||
      !rows_map<T>(&tk, k, s.B, s.Sk, s.Hkv, s.D, kDqKeys) ||
      !rows_map<T>(&tv, v, s.B, s.Sk, s.Hkv, s.D, kDqKeys)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dq_wgmma_kernel<T, DT>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sq + 127) / 128, s.H, s.B);
  kernel<<<grid, kWsThreads, smem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), s.Sq, s.Sk, s.H,
      s.Hkv, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const Shape& s, cudaStream_t st) {
  constexpr size_t smem =
      1024 + (size_t)2 * kDkvKeys * DT * 2 +
      kDkvStages * ((size_t)2 * kDkvQRows * DT * 2 + 1024 +
                    (size_t)kDkvKeys * kDkvQRows * 4) +
      8 * (1 + 3 * kDkvStages);
  const size_t stats = (size_t)s.B * s.H * s.Sq;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  if (!rows_map<T>(&tq, q, s.B, s.Sq, s.H, s.D, kDkvQRows) ||
      !rows_map<T>(&tdo, dout, s.B, s.Sq, s.H, s.D, kDkvQRows) ||
      !rows_map<T>(&tk, k, s.B, s.Sk, s.Hkv, s.D, kDkvKeys) ||
      !rows_map<T>(&tv, v, s.B, s.Sk, s.Hkv, s.D, kDkvKeys) ||
      !stats_map(&tlse, lse, stats, kDkvQRows + 4) ||
      !stats_map(&tdelta, delta, stats, kDkvQRows + 4)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bwd_dkv_wgmma_kernel<T, DT>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sk + kDkvKeys - 1) / kDkvKeys, s.Hkv, s.B);
  kernel<<<grid, kWsThreads, smem, st>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<T*>(dk), static_cast<T*>(dv),
      s.Sq, s.Sk, s.H, s.Hkv, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

// bfloat16 / float16 at D <= 128 take the Hopper kernels; float32, and D up
// to 512 in any dtype, the CUDA-core ones.
template <typename T>
cudaError_t fwd_dt(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Shape& s, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (s.D <= 64) return fwd_wgmma<T, 64>(q, k, v, o, lse, s, st);
    if (s.D <= 128) return fwd_wgmma<T, 128>(q, k, v, o, lse, s, st);
  } else {
    if (s.D <= 64) return fwd<T, 64, 64, 64>(q, k, v, o, lse, s, st);
    if (s.D <= 128) return fwd<T, 128, 64, 64>(q, k, v, o, lse, s, st);
  }
  if (s.D <= 256) return fwd<T, 256, 32, 32>(q, k, v, o, lse, s, st);
  return fwd<T, 512, 16, 16>(q, k, v, o, lse, s, st);
}

template <typename T>
cudaError_t bwd_dq_dt(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const Shape& s, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (s.D <= 64) {
      return bwd_dq_wgmma<T, 64>(q, k, v, dout, lse, delta, dq, s, st);
    }
    if (s.D <= 128) {
      return bwd_dq_wgmma<T, 128>(q, k, v, dout, lse, delta, dq, s, st);
    }
  } else {
    if (s.D <= 64) {
      return bwd_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, s, st);
    }
    if (s.D <= 128) {
      return bwd_dq<T, 128, 64, 64>(q, k, v, dout, lse, delta, dq, s, st);
    }
  }
  if (s.D <= 256) {
    return bwd_dq<T, 256, 32, 32>(q, k, v, dout, lse, delta, dq, s, st);
  }
  return bwd_dq<T, 512, 16, 16>(q, k, v, dout, lse, delta, dq, s, st);
}

template <typename T>
cudaError_t bwd_dkv_dt(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const Shape& s, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (s.D <= 64) {
      return bwd_dkv_wgmma<T, 64>(q, k, v, dout, lse, delta, dk, dv, s, st);
    }
    if (s.D <= 128) {
      return bwd_dkv_wgmma<T, 128>(q, k, v, dout, lse, delta, dk, dv, s,
                                   st);
    }
  } else {
    if (s.D <= 64) {
      return bwd_dkv<T, 64, 64, 64>(q, k, v, dout, lse, delta, dk, dv, s,
                                    st);
    }
    if (s.D <= 128) {
      return bwd_dkv<T, 128, 64, 64>(q, k, v, dout, lse, delta, dk, dv, s,
                                     st);
    }
  }
  if (s.D <= 256) {
    return bwd_dkv<T, 256, 32, 32>(q, k, v, dout, lse, delta, dk, dv, s, st);
  }
  return bwd_dkv<T, 512, 16, 16>(q, k, v, dout, lse, delta, dk, dv, s, st);
}

bool bad_shape(const Shape& s) {
  return s.B <= 0 || s.Sq <= 0 || s.Sk <= 0 || s.H <= 0 || s.Hkv <= 0 ||
         s.H % s.Hkv != 0 || s.D <= 0 || s.D % 8 != 0 || s.D > 512 ||
         s.H > 65535 || s.B > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Pointers are device
// pointers to contiguous q / o / dout / dq [B, Sq, H, D], k / v / dk / dv
// [B, Sk, Hkv, D], lse / delta [B, H, Sq] fp32; every tensor starts on a
// 16-byte boundary (the Hopper kernels read theirs with TMA and return
// cudaErrorInvalidValue, launching nothing, where one does not). Each
// returns the cudaError_t of its launch (0 = ok).
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq, int Sk, int H, int Hkv,
                                      int D, float scale, int causal,
                                      int dtype, void* stream) {
  const Shape s{B, Sq, Sk, H, Hkv, D, causal, scale};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(fwd_dt<float>(q, k, v, o, lse, s, st));
    case 1:
      return static_cast<int>(fwd_dt<__half>(q, k, v, o, lse, s, st));
    case 2:
      return static_cast<int>(fwd_dt<__nv_bfloat16>(q, k, v, o, lse, s, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int pt_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int B, int Sq, int Sk,
                                         int H, int Hkv, int D, float scale,
                                         int causal, int dtype,
                                         void* stream) {
  const Shape s{B, Sq, Sk, H, Hkv, D, causal, scale};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          bwd_dq_dt<float>(q, k, v, dout, lse, delta, dq, s, st));
    case 1:
      return static_cast<int>(
          bwd_dq_dt<__half>(q, k, v, dout, lse, delta, dq, s, st));
    case 2:
      return static_cast<int>(
          bwd_dq_dt<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, s, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int pt_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int Sq,
                                          int Sk, int H, int Hkv, int D,
                                          float scale, int causal, int dtype,
                                          void* stream) {
  const Shape s{B, Sq, Sk, H, Hkv, D, causal, scale};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          bwd_dkv_dt<float>(q, k, v, dout, lse, delta, dk, dv, s, st));
    case 1:
      return static_cast<int>(
          bwd_dkv_dt<__half>(q, k, v, dout, lse, delta, dk, dv, s, st));
    case 2:
      return static_cast<int>(bwd_dkv_dt<__nv_bfloat16>(
          q, k, v, dout, lse, delta, dk, dv, s, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
