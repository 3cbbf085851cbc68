// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K2 _fwd_kernel     (via _fa_forward, :88)      -> flash_fwd_[mma_]kernel
//   K3 _bwd_dq_kernel  (via _flash_bwd_core, :263) -> flash_bwd_dq_[mma_]kernel
//   K4 _bwd_dkv_kernel (via _flash_bwd_core, :263) -> flash_bwd_dkv_[mma_]kernel
// q is [B, Sq, H, D], k and v are [B, Sk, Hkv, D], all contiguous and read
// in place by row strides (no transpose, no padding of S or D in memory).
// GQA maps q head h to kv head h / (H / Hkv).
//
// Bound: operations. At the training shape (S = 2048, D = 128) every kernel
// does 2 * D flops per score and reads each input row once per tile of the
// other side, hundreds of flops per byte, so the card's arithmetic rate is
// the limit. Two implementations of each kernel:
//   - bfloat16 / float16 at D <= 128 (the training path): products on the
//     tensor cores with mma.sync.m16n8k16 and fp32 accumulators, 4 warps
//     per CTA, each warp owning 16 rows; scores, P and dS never leave the
//     registers (the *_mma_kernel functions below);
//   - float32, and D up to 256 in any dtype: fp32 FMAs on the CUDA cores,
//     tiles of BR rows x BC columns through shared memory, 256 threads as
//     16 row lanes x 16 column lanes, each thread owning a BR/16 x BC/16
//     block of scores and a BR/16 x D/16 block of the output accumulator
//     in registers; the 16 lanes of a row are one half-warp, so row max
//     and row sum are four shuffles.
// wgmma, TMA loads, double buffering and warp specialisation are later
// work. Common to both:
//   - the [Sq, Sk] score matrix never leaves the CTA: the forward keeps an
//     online softmax (m, l, acc in fp32), the backward recomputes
//     P = exp(S - LSE) from the saved LSE;
//   - causal loops skip wholly masked blocks with the JAX bounds: hi for
//     K2/K3 (flash_attention.py:53-57, :137-141), lo for K4 (:172); K2/K3
//     launch the longest causal q-blocks first;
//   - K4 serves one kv head and loops over the group's q heads itself, so
//     GQA needs no repeated K/V and the group sum stays in fp32.
//
// Semantics kept from the Pallas kernels: masked scores are -1e30 (not
// -inf), l is clamped to 1e-30, the causal mask is top-left (qid >= kid),
// P is rounded to v's dtype before P.V and dS to q's dtype before its
// products, outputs are stored in the input dtype, LSE in fp32. delta =
// rowsum(dO * O) is computed outside the kernels, in fp32, by the wrapper.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// Tensor-core versions for bfloat16 and float16 at D <= 128: the same three
// functions with their products on mma.sync.m16n8k16 (fp32 accumulate).
// 128 threads = 4 warps per CTA; each warp owns 16 rows of the CTA's block
// (q rows for K2/K3, key rows for K4). Scores, P and dS stay in the
// accumulator registers: a C fragment of two neighbouring n-tiles is the A
// fragment of the next product once packed to 16 bits, which is where P
// and dS are rounded to the input dtype. Row max / sum are two shuffles
// inside the quad of lanes that share a row. Tiles have a pitch of DT + 8
// elements, so every 32-bit fragment load hits 32 distinct banks.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  __device__ __forceinline__ static void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit elements of one column, rows r and r + 1, as one register
// (the B fragment of a product whose k index runs down the tile's rows).
template <typename T, int P>
__device__ __forceinline__ uint32_t ld_col2(const T* p) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return (uint32_t)u[0] | ((uint32_t)u[P] << 16);
}

// The A fragment of rows [r, r + 16) x columns [c, c + 16) of a tile.
template <typename T, int P>
__device__ __forceinline__ void ld_a(uint32_t* a, const T* tile, int r,
                                     int c, int g, int t) {
  const T* p = tile + (r + g) * P + c + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * P);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * P + 8);
}

// Rows [r0, r0 + R) of one head into a tile [R][DT + 8] with 16-byte
// stores; rows >= S and columns >= D are zero.
template <typename T, int R, int DT>
__device__ __forceinline__ void load_tile16(T* __restrict__ dst,
                                            const T* __restrict__ src, int r0,
                                            int S, size_t row_stride, int D) {
  constexpr int P = DT + 8;
  constexpr int NV = DT / 8;
  for (int idx = threadIdx.x; idx < R * NV; idx += kMmaThreads) {
    const int r = idx / NV;
    const int c = (idx - r * NV) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S && c < D) {
      val = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * row_stride + c));
    }
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K2 on tensor cores: CTA = 64 q rows x (head, batch); key tiles of 64.
template <typename T, int DT>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int Sq, int Sk, int H,
                         int Hkv, int D, float scale, int causal) {
  constexpr int BR = 64, BC = 64, P = DT + 8;
  constexpr int KS = DT / 16, NT = BC / 8, DN = DT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BR * P;
  T* Vs = Ks + BC * P;

  const int nq = (Sq + BR - 1) / BR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qrs = (size_t)H * D, krs = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * Sk * krs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * krs + (size_t)kvh * D;
  load_tile16<T, BR, DT>(Qs, q + (size_t)b * Sq * qrs + (size_t)h * D, q0,
                         Sq, qrs, D);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ld_a<T, P>(qa[kk], Qs, warp * 16, kk * 16,
                                             g, t);

  const int r0 = q0 + warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  }

  const int nk = (Sk + BC - 1) / BC;
  const int hi = causal ? min(nk, (q0 + BR + BC - 1) / BC) : nk;
  for (int ik = 0; ik < hi; ++ik) {
    const int k0 = ik * BC;
    __syncthreads();
    load_tile16<T, BC, DT>(Ks, kb, k0, Sk, krs, D);
    load_tile16<T, BC, DT>(Vs, vb, k0, Sk, krs, D);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const T* kp = Ks + (nt * 8 + g) * P + kk * 16 + 2 * t;
        Mma<T>::run(s[nt], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + (e >> 1) * 8;
        const int kj = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = kj < Sk && (!causal || qi >= kj);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        ps[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(ps[i]);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const T* vp = Vs + (kk * 16 + 2 * t) * P + g;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        Mma<T>::run(acc[dn], pa, ld_col2<T, P>(vp + dn * 8),
                    ld_col2<T, P>(vp + 8 * P + dn * 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + i * 8;
    if (qi >= Sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)b * Sq + qi) * qrs + (size_t)h * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d < D) {
        orow[d] = Cvt<T>::to(acc[dn][2 * i] / ll);
        orow[d + 1] = Cvt<T>::to(acc[dn][2 * i + 1] / ll);
      }
    }
    if (t == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(ll);
  }
}

// K3 on tensor cores: CTA = 64 q rows x (head, batch); key tiles of 64.
template <typename T, int DT>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
                            int D, float scale, int causal) {
  constexpr int BR = 64, BC = 64, P = DT + 8;
  constexpr int KS = DT / 16, NT = BC / 8, DN = DT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BR * P;
  T* Ks = dOs + BR * P;
  T* Vs = Ks + BC * P;

  const int nq = (Sq + BR - 1) / BR;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qrs = (size_t)H * D, krs = (size_t)Hkv * D;
  const size_t qoff = (size_t)b * Sq * qrs + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * krs + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * krs + (size_t)kvh * D;
  load_tile16<T, BR, DT>(Qs, q + qoff, q0, Sq, qrs, D);
  load_tile16<T, BR, DT>(dOs, dout + qoff, q0, Sq, qrs, D);

  const int r0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + i * 8;
    lse_r[i] = qi < Sq ? lse[((size_t)b * H + h) * Sq + qi] : 0.f;
    delta_r[i] = qi < Sq ? delta[((size_t)b * H + h) * Sq + qi] : 0.f;
  }
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  }

  const int nk = (Sk + BC - 1) / BC;
  const int hi = causal ? min(nk, (q0 + BR + BC - 1) / BC) : nk;
  for (int ik = 0; ik < hi; ++ik) {
    const int k0 = ik * BC;
    __syncthreads();
    load_tile16<T, BC, DT>(Ks, kb, k0, Sk, krs, D);
    load_tile16<T, BC, DT>(Vs, vb, k0, Sk, krs, D);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      ld_a<T, P>(qa, Qs, warp * 16, kk * 16, g, t);
      ld_a<T, P>(oa, dOs, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int off = (nt * 8 + g) * P + kk * 16 + 2 * t;
        Mma<T>::run(s[nt], qa, ld32(Ks + off), ld32(Ks + off + 8));
        Mma<T>::run(dp[nt], oa, ld32(Vs + off), ld32(Vs + off + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + (e >> 1) * 8;
        const int kj = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = kj < Sk && (!causal || qi >= kj);
        const float x = ok ? s[nt][e] * scale : kNegInf;
        const float p = expf(x - lse_r[e >> 1]);
        s[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]);  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t da[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const T* kp = Ks + (kk * 16 + 2 * t) * P + g;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        Mma<T>::run(acc[dn], da, ld_col2<T, P>(kp + dn * 8),
                    ld_col2<T, P>(kp + 8 * P + dn * 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + i * 8;
    if (qi >= Sq) continue;
    T* row = dq + ((size_t)b * Sq + qi) * qrs + (size_t)h * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d < D) {
        row[d] = Cvt<T>::to(scale * acc[dn][2 * i]);
        row[d + 1] = Cvt<T>::to(scale * acc[dn][2 * i + 1]);
      }
    }
  }
}

// K4 on tensor cores: CTA = 64 key rows x (kv head, batch), looping over
// the group's q heads and q tiles of 32 rows. The warp computes S^T and
// dP^T (its 16 keys x the tile's 32 queries), so P^T and dS^T are A
// fragments of dV += P^T dO and dK += dS^T Q.
template <typename T, int DT>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int Sq,
                             int Sk, int H, int Hkv, int D, float scale,
                             int causal) {
  constexpr int BR = 64, BC = 32, P = DT + 8;
  constexpr int KS = DT / 16, NT = BC / 8, DN = DT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BR * P;
  T* Qs = Vs + BR * P;
  T* dOs = Qs + BC * P;
  float* lse_s = reinterpret_cast<float*>(dOs + BC * P);
  float* delta_s = lse_s + BC;

  const int k0 = blockIdx.x * BR;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qrs = (size_t)H * D, krs = (size_t)Hkv * D;
  const size_t koff = (size_t)b * Sk * krs + (size_t)kvh * D;
  load_tile16<T, BR, DT>(Ks, k + koff, k0, Sk, krs, D);
  load_tile16<T, BR, DT>(Vs, v + koff, k0, Sk, krs, D);

  const int j0 = k0 + warp * 16 + g;  // this lane's keys: j0 and j0 + 8
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;
  }

  const int nq = (Sq + BC - 1) / BC;
  const int lo = causal ? k0 / BC : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const size_t qoff = (size_t)b * Sq * qrs + (size_t)h * D;
    const float* lse_bh = lse + ((size_t)b * H + h) * Sq;
    const float* delta_bh = delta + ((size_t)b * H + h) * Sq;
    for (int iq = lo; iq < nq; ++iq) {
      const int q0 = iq * BC;
      __syncthreads();
      load_tile16<T, BC, DT>(Qs, q + qoff, q0, Sq, qrs, D);
      load_tile16<T, BC, DT>(dOs, dout + qoff, q0, Sq, qrs, D);
      for (int i = threadIdx.x; i < BC; i += kMmaThreads) {
        lse_s[i] = q0 + i < Sq ? lse_bh[q0 + i] : 0.f;
        delta_s[i] = q0 + i < Sq ? delta_bh[q0 + i] : 0.f;
      }
      __syncthreads();

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ld_a<T, P>(ka, Ks, warp * 16, kk * 16, g, t);
        ld_a<T, P>(va, Vs, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int off = (nt * 8 + g) * P + kk * 16 + 2 * t;
          Mma<T>::run(s[nt], ka, ld32(Qs + off), ld32(Qs + off + 8));
          Mma<T>::run(dp[nt], va, ld32(dOs + off), ld32(dOs + off + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = j0 + (e >> 1) * 8;
          const int c = nt * 8 + 2 * t + (e & 1);
          const int qi = q0 + c;
          const bool ok = qi < Sq && (!causal || qi >= kj);
          const float x = ok ? s[nt][e] * scale : kNegInf;
          const float p = expf(x - lse_s[c]);
          s[nt][e] = p;                                  // P^T
          dp[nt][e] = p * (dp[nt][e] - delta_s[c]);      // dS^T
        }
      }
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        const uint32_t pa[4] = {
            Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
            Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
            Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {
            Mma<T>::pack(dp[2 * kk][0], dp[2 * kk][1]),
            Mma<T>::pack(dp[2 * kk][2], dp[2 * kk][3]),
            Mma<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            Mma<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
        const int off = (kk * 16 + 2 * t) * P + g;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          Mma<T>::run(dva[dn], pa, ld_col2<T, P>(dOs + off + dn * 8),
                      ld_col2<T, P>(dOs + off + 8 * P + dn * 8));
          Mma<T>::run(dka[dn], da, ld_col2<T, P>(Qs + off + dn * 8),
                      ld_col2<T, P>(Qs + off + 8 * P + dn * 8));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = j0 + i * 8;
    if (kj >= Sk) continue;
    const size_t off = ((size_t)b * Sk + kj) * krs + (size_t)kvh * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d < D) {
        dk[off + d] = Cvt<T>::to(scale * dka[dn][2 * i]);
        dk[off + d + 1] = Cvt<T>::to(scale * dka[dn][2 * i + 1]);
        dv[off + d] = Cvt<T>::to(dva[dn][2 * i]);
        dv[off + d + 1] = Cvt<T>::to(dva[dn][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers. DT (the padded head width in shared memory) is 64, 128 or 256;
// tiles are 64 x 64 up to DT = 128 and 32 x 32 at DT = 256, which keeps the
// per-thread accumulators at 64 floats or fewer and shared memory under
// the 227 KB a CTA may use (fp32 K4 at DT = 128: 166 KB).
// ---------------------------------------------------------------------------
struct Shape {
  int B, Sq, Sk, H, Hkv, D, causal;
  float scale;
};

// Raise the kernel's dynamic shared-memory limit once per instance (`done`
// is a static of the instance's launcher), so the call never falls inside
// a CUDA-graph capture: an instance's first launch is an eager one.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

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

template <typename T, int DT>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    void* lse, const Shape& s, cudaStream_t st) {
  constexpr size_t smem = (size_t)3 * 64 * (DT + 8) * sizeof(T);
  auto kernel = flash_fwd_mma_kernel<T, DT>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sq + 63) / 64, s.H, s.B);
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s.Sq, s.Sk, s.H, s.Hkv, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t bwd_dq_mma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, const Shape& s, cudaStream_t st) {
  constexpr size_t smem = (size_t)4 * 64 * (DT + 8) * sizeof(T);
  auto kernel = flash_bwd_dq_mma_kernel<T, DT>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sq + 63) / 64, s.H, s.B);
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s.Sq, s.Sk, s.H, s.Hkv, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t bwd_dkv_mma(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, const Shape& s, cudaStream_t st) {
  constexpr size_t smem = (size_t)(2 * 64 + 2 * 32) * (DT + 8) * sizeof(T) +
                          2 * 32 * sizeof(float);
  auto kernel = flash_bwd_dkv_mma_kernel<T, DT>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Sk + 63) / 64, s.Hkv, s.B);
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s.Sq, s.Sk, s.H, s.Hkv, s.D,
      s.scale, s.causal);
  return cudaGetLastError();
}

// bfloat16 / float16 at D <= 128 take the tensor-core kernels; float32,
// and D up to 256 in any dtype, the CUDA-core ones.
template <typename T>
cudaError_t fwd_dt(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Shape& s, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (s.D <= 64) return fwd_mma<T, 64>(q, k, v, o, lse, s, st);
    if (s.D <= 128) return fwd_mma<T, 128>(q, k, v, o, lse, s, st);
  } else {
    if (s.D <= 64) return fwd<T, 64, 64, 64>(q, k, v, o, lse, s, st);
    if (s.D <= 128) return fwd<T, 128, 64, 64>(q, k, v, o, lse, s, st);
  }
  return fwd<T, 256, 32, 32>(q, k, v, o, lse, s, st);
}

template <typename T>
cudaError_t bwd_dq_dt(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const Shape& s, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (s.D <= 64) {
      return bwd_dq_mma<T, 64>(q, k, v, dout, lse, delta, dq, s, st);
    }
    if (s.D <= 128) {
      return bwd_dq_mma<T, 128>(q, k, v, dout, lse, delta, dq, s, st);
    }
  } else {
    if (s.D <= 64) {
      return bwd_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, s, st);
    }
    if (s.D <= 128) {
      return bwd_dq<T, 128, 64, 64>(q, k, v, dout, lse, delta, dq, s, st);
    }
  }
  return bwd_dq<T, 256, 32, 32>(q, k, v, dout, lse, delta, dq, s, st);
}

template <typename T>
cudaError_t bwd_dkv_dt(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const Shape& s, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (s.D <= 64) {
      return bwd_dkv_mma<T, 64>(q, k, v, dout, lse, delta, dk, dv, s, st);
    }
    if (s.D <= 128) {
      return bwd_dkv_mma<T, 128>(q, k, v, dout, lse, delta, dk, dv, s, st);
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
  return bwd_dkv<T, 256, 32, 32>(q, k, v, dout, lse, delta, dk, dv, s, st);
}

bool bad_shape(const Shape& s) {
  return s.B <= 0 || s.Sq <= 0 || s.Sk <= 0 || s.H <= 0 || s.Hkv <= 0 ||
         s.H % s.Hkv != 0 || s.D <= 0 || s.D % 8 != 0 || s.D > 256 ||
         s.H > 65535 || s.B > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Pointers are device
// pointers to contiguous q / o / dout / dq [B, Sq, H, D], k / v / dk / dv
// [B, Sk, Hkv, D], lse / delta [B, H, Sq] fp32; every tensor starts on a
// 16-byte boundary. Each returns the cudaError_t of its launch (0 = ok).
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
