// Fused linear + softmax cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/fused_ce.py:
//   K5 _fwd_kernel    (via _fwd_partials, :104) -> fce_fwd_kernel and
//                                                  fce_merge_kernel
//   K6 _bwd_dh_kernel (via _bwd_impl, :192)     -> fce_bwd_dh_wgmma_kernel
//   K7 _bwd_dw_kernel (via _bwd_impl, :207)     -> fce_bwd_dw_wgmma_kernel
// (K6 / K7 for bfloat16 / float16 with H and V multiples of 8, the training
// path: wgmma, TMA and warp specialisation, designed below with the
// kernels; float32, and H or V not a multiple of 8, take
// fce_bwd_dh_kernel / fce_bwd_dw_kernel, the mma.sync design that follows).
// h is [N, H], W is [H, V] (Paddle's [in, out] layout), labels [N] int32,
// all contiguous; s = h W is never written to memory. Ragged N, H and V are
// masked here (no padding in memory); offsets into h, W and the fp32
// accumulators are 64-bit.
//
// Bound: operations. At the training shape (N = 4096, H = 4096, V = 32000,
// bf16) K5 does 2NHV = 1.07e12 flops (1.09 ms at 989 TFLOP/s), K6 and K7
// 4NHV each (s recomputed, then the product): 2.17 ms. W alone is 262 MB,
// 0.08 ms at 3.35 TB/s. Design of K5 and of the mma.sync K6 / K7:
//   - s is computed in 128 x 128 tiles by 8 warps (4 along rows x 2 along
//     columns, 32 x 64 each), contracting over H in chunks of 64 (32 for
//     fp32) through a two-stage cp.async ring in shared memory (16-byte
//     copies when H and V are multiples of 8 (16-bit) or 4 (fp32), element
//     copies otherwise);
//   - bfloat16 / float16 products run on the tensor cores with
//     mma.sync.m16n8k16 and fp32 accumulators, their fragments loaded with
//     ldmatrix (.trans where the tile's contiguous index is not the one a
//     fragment register pairs: W in s = h W, h^T in K7); rows are padded by
//     8 elements so those loads are free of bank conflicts. float32 products
//     run on the CUDA cores with fp32 FMAs into the same register layout, so
//     the epilogues are shared.
//   - K5: the TPU walks the whole vocab of a row block in one sequential
//     grid. Here each CTA takes 128 rows and one contiguous split of the
//     vocab tiles, so N = 4096 gives 32 x 17 CTAs instead of 32; every
//     thread keeps an online (max, sum-exp, label logit) for its 4 rows over
//     its columns, merged over the quad and the two column warps at the end.
//     A second launch (fce_merge_kernel) merges the splits' partials per
//     row: M = max m_i, L = sum l_i exp(m_i - M), z = sum z_i.
//   - K6 / K7: the TPU carries a [BR, H] (dh) or [H, BV] (dW) fp32
//     accumulator in VMEM across a sequential grid axis; at H = 4096 those
//     are 2 MB and fit nowhere on chip. Each CTA instead computes the
//     rounded cotangent dl = (softmax - onehot) g for a 128-row x 512-column
//     (K6) or 512-row x 128-column (K7) block (256 for fp32) into shared
//     memory, then walks H in chunks of 128 and adds each chunk's product
//     (dl W^T or h^T dl) into an fp32 [N, H] or [H, V] buffer with
//     red.global.add.f32. The wrapper zeroes the buffer and rounds it once
//     to the output dtype. s is computed once per CTA, never per H chunk.
//     The order of the sums across CTAs changes from run to run.
//
// Semantics kept from the Pallas kernels: s in fp32; columns >= V are
// -1e30 and carry no probability; z is the fp32 logit at the label, 0 when
// label - vocab_offset is outside [0, V); dl is rounded to W's dtype before
// dl W^T (K6) and to h's dtype before h^T dl (K7); rows with g = 0 (and
// rows >= N) add nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int kTile = 128;     // rows and columns of an s tile
constexpr float kNegInf = -1e30f;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ __forceinline__ static float to(float x) { return x; }
};

template <>
struct Cvt<__half> {
  __device__ __forceinline__ static __half to(float x) {
    return __float2half_rn(x);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 to(float x) {
    return __float2bfloat16_rn(x);
  }
};

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
};

// Contraction chunk and shared-memory layout of the operand tiles, in
// elements. Rows are padded so that the 8 rows an ldmatrix phase (16-bit)
// or a warp's loads (fp32) touch fall in distinct banks.
template <typename T>
struct Lay {
  static constexpr int KC = sizeof(T) == 2 ? 64 : 32;
  static constexpr int PAD = sizeof(T) == 2 ? 8 : 4;
  static constexpr int PK = KC + PAD;     // [128][KC] tiles
  static constexpr int PT = kTile + PAD;  // [KC][128] tiles
  static constexpr int STAGE = kTile * PK + KC * PT;
  static constexpr int VS = sizeof(T) == 2 ? 512 : 256;  // staged dl width
  static constexpr int PD = VS + PAD;     // [128][VS] dl tile
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// tile[r][c] = src[(r0 + r) * ld + c0 + c] for r < R, c < C, zero where
// r0 + r >= Rmax or c0 + c >= Cmax. VEC: 16-byte cp.async copies (ld, c0
// and Cmax are multiples of the vector and src is 16-byte aligned);
// otherwise element loads and stores.
template <typename T, int R, int C, int P, bool VEC>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          size_t ld, int r0, int c0, int Rmax,
                                          int Cmax) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    constexpr int NV = C / E;
    for (int idx = threadIdx.x; idx < R * NV; idx += kThreads) {
      const int r = idx / NV;
      const int c = (idx - r * NV) * E;
      const bool in = r0 + r < Rmax && c0 + c < Cmax;
      const T* p = in ? src + (size_t)(r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * P + c, p, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
      const int r = idx / C;
      const int c = idx - r * C;
      const bool in = r0 + r < Rmax && c0 + c < Cmax;
      dst[r * P + c] = in ? src[(size_t)(r0 + r) * ld + c0 + c]
                          : Cvt<T>::to(0.f);
    }
  }
}

// Two-stage ring: load(i, stage) fills chunk i, compute(i, stage) reads it.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int n, Load load, Compute compute) {
  load(0, 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(i, i & 1);
    __syncthreads();  // the stage is free for the load two chunks ahead
  }
}

// Element (m, k) of an operand tile stored k-contiguous (x[m][k], KCONT) or
// m-contiguous (x[k][m]).
template <typename T, bool KCONT, int P>
__device__ __forceinline__ T elem(const T* x, int m, int k) {
  return KCONT ? x[m * P + k] : x[k * P + m];
}

// Four 8 x 8 16-bit matrices; lane L gives the address of row L % 8 of
// matrix L / 8. TRANS delivers each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// acc[mt][nt][e] += sum over k < KC of A(m, k) B(k, n) for this warp's
// 32 x 64 block: m = wm*32 + mt*16 + g + 8*(e>>1), n = wn*64 + nt*8 + 2t +
// (e&1) (the mma.sync C layout, which the fp32 path keeps too). A is
// stored k- or m-contiguous (A_K), B k- or n-contiguous (B_K); 16-bit
// fragments come from ldmatrix, transposed where the tile's contiguous
// index is not the one the fragment pairs.
template <typename T, bool A_K, int PA, bool B_K, int PB>
__device__ __forceinline__ void warp_product(float (&acc)[2][8][4],
                                             const T* A, const T* B, int wm,
                                             int wn, int g, int t) {
  constexpr int KC = Lay<T>::KC;
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, lr = lane & 7, li = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = wm * 32 + mt * 16;
        if constexpr (A_K) {
          ldsm4<false>(a[mt], A + (m0 + lr + 8 * (li & 1)) * PA + kk +
                                  8 * (li >> 1));
        } else {
          ldsm4<true>(a[mt], A + (kk + lr + 8 * (li >> 1)) * PA + m0 +
                                 8 * (li & 1));
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n0 = wn * 64 + np * 16;
        uint32_t r[4];
        if constexpr (B_K) {
          ldsm4<false>(r, B + (n0 + lr + 8 * (li >> 1)) * PB + kk +
                              8 * (li & 1));
        } else {
          ldsm4<true>(r, B + (kk + lr + 8 * (li & 1)) * PB + n0 +
                             8 * (li >> 1));
        }
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        Mma<T>::run(acc[0][nt], a[0], b[nt][0], b[nt][1]);
        Mma<T>::run(acc[1][nt], a[1], b[nt][0], b[nt][1]);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[2][2], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[mt][i] = elem<T, A_K, PA>(A, wm * 32 + mt * 16 + g + 8 * i, k);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          b[nt][j] = elem<T, B_K, PB>(B, wn * 64 + nt * 8 + 2 * t + j, k);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] = fmaf(a[mt][e >> 1], b[nt][e & 1], acc[mt][nt][e]);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
}

// This thread's warp / lane coordinates.
struct Lane {
  int wm, wn, g, t;
  __device__ Lane() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wm = warp & 3;
    wn = warp >> 2;
    g = lane >> 2;
    t = lane & 3;
  }
  // Tile-local row of accumulator row slot ri = mt * 2 + (e >> 1), and
  // column of (nt, e).
  __device__ int row(int ri) const {
    return wm * 32 + (ri >> 1) * 16 + g + 8 * (ri & 1);
  }
  __device__ int col(int nt, int e) const {
    return wn * 64 + nt * 8 + 2 * t + (e & 1);
  }
};

// s = h[r0:r0+128] W[:, v0:v0+128] in fp32 (zero outside N x V).
template <typename T, bool VEC>
__device__ __forceinline__ void s_tile(float (&acc)[2][8][4],
                                       const T* __restrict__ h,
                                       const T* __restrict__ w, T* stage,
                                       int r0, int v0, int N, int H, int V,
                                       const Lane& ln) {
  using L = Lay<T>;
  zero(acc);
  pipeline(
      (H + L::KC - 1) / L::KC,
      [&](int i, int s) {
        T* As = stage + s * L::STAGE;
        load_tile<T, kTile, L::KC, L::PK, VEC>(As, h, H, r0, i * L::KC, N,
                                               H);
        load_tile<T, L::KC, kTile, L::PT, VEC>(As + kTile * L::PK, w, V,
                                               i * L::KC, v0, H, V);
      },
      [&](int, int s) {
        const T* As = stage + s * L::STAGE;
        warp_product<T, true, L::PK, false, L::PT>(
            acc, As, As + kTile * L::PK, ln.wm, ln.wn, ln.g, ln.t);
      });
}

// Per-row inputs of the backward for this thread's 4 rows of a tile.
struct RowsIn {
  float lse[4], g[4];
  int lab[4];
  __device__ void load(const float* lse_p, const float* g_p, const int* lab_p,
                       int offset, int r0, int N, const Lane& ln) {
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int r = r0 + ln.row(ri);
      const bool in = r < N;
      lse[ri] = in ? lse_p[r] : 0.f;
      g[ri] = in ? g_p[r] : 0.f;
      lab[ri] = in ? lab_p[r] - offset : -1;
    }
  }
};

// dl = (exp(s - lse) - onehot(label)) g, 0 at columns >= V; s tile at
// columns v0.. of rows r0.. in acc. store(rl, cl, rounded dl).
template <typename T, class Store>
__device__ __forceinline__ void cotangent(const float (&acc)[2][8][4],
                                          const RowsIn& in, int v0, int V,
                                          const Lane& ln, Store store) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = mt * 2 + (e >> 1);
        const int cl = ln.col(nt, e);
        const int col = v0 + cl;
        float dl = 0.f;
        if (col < V) {
          const float p = expf(acc[mt][nt][e] - in.lse[ri]);
          dl = (p - (col == in.lab[ri] ? 1.f : 0.f)) * in.g[ri];
        }
        store(ln.row(ri), cl, Cvt<T>::to(dl));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5: forward. CTA = 128 rows x one split of the vocab tiles; writes the
// split's (m, l, z) per row into part[3][splits][N].
// ---------------------------------------------------------------------------
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                   const int* __restrict__ labels, int offset,
                   float* __restrict__ part, int N, int H, int V,
                   int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[3][2][kTile];
  T* stage = reinterpret_cast<T*>(smem);
  const Lane ln;
  const int r0 = blockIdx.x * kTile;
  const int split = blockIdx.y, splits = gridDim.y;
  const int nvt = (V + kTile - 1) / kTile;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, nvt);

  int lab[4];
  float m[4], l[4], z[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int r = r0 + ln.row(ri);
    lab[ri] = r < N ? labels[r] - offset : -1;
    m[ri] = kNegInf;
    l[ri] = 0.f;
    z[ri] = 0.f;
  }
  float acc[2][8][4];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * kTile;
    s_tile<T, VEC>(acc, h, w, stage, r0, v0, N, H, V, ln);
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = mt * 2 + (e >> 1);
          const int col = v0 + ln.col(nt, e);
          if (col >= V) acc[mt][nt][e] = kNegInf;
          if (col == lab[ri] && col < V) z[ri] += acc[mt][nt][e];
          mx[ri] = fmaxf(mx[ri], acc[mt][nt][e]);
        }
      }
    }
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const float mn = fmaxf(m[ri], mx[ri]);
      l[ri] *= expf(m[ri] - mn);
      m[ri] = mn;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = mt * 2 + (e >> 1);
          if (v0 + ln.col(nt, e) < V) l[ri] += expf(acc[mt][nt][e] - m[ri]);
        }
      }
    }
  }

  // Merge the quad's four lanes (same rows, other columns), then the two
  // column warps of each row through shared memory.
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[ri], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[ri], off);
      const float oz = __shfl_xor_sync(0xffffffffu, z[ri], off);
      const float mn = fmaxf(m[ri], om);
      l[ri] = l[ri] * expf(m[ri] - mn) + ol * expf(om - mn);
      m[ri] = mn;
      z[ri] += oz;
    }
    if (ln.t == 0) {
      red[0][ln.wn][ln.row(ri)] = m[ri];
      red[1][ln.wn][ln.row(ri)] = l[ri];
      red[2][ln.wn][ln.row(ri)] = z[ri];
    }
  }
  __syncthreads();
  const int rl = threadIdx.x;
  if (rl < kTile && r0 + rl < N) {
    const float m0 = red[0][0][rl], m1 = red[0][1][rl];
    const float mn = fmaxf(m0, m1);
    const size_t o = (size_t)split * N + r0 + rl;
    const size_t plane = (size_t)splits * N;
    part[o] = mn;
    part[plane + o] = red[1][0][rl] * expf(m0 - mn) +
                      red[1][1][rl] * expf(m1 - mn);
    part[2 * plane + o] = red[2][0][rl] + red[2][1][rl];
  }
}

// K5, second launch: per row, M = max m_i, L = sum l_i exp(m_i - M),
// z = sum z_i over the splits.
__global__ void fce_merge_kernel(const float* __restrict__ part,
                                 float* __restrict__ m, float* __restrict__ l,
                                 float* __restrict__ z, int N, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const size_t plane = (size_t)splits * N;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part[(size_t)s * N + r]);
  float L = 0.f, Z = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (size_t)s * N + r;
    L += part[plane + o] * expf(part[o] - M);
    Z += part[2 * plane + o];
  }
  m[r] = M;
  l[r] = L;
  z[r] = Z;
}

// ---------------------------------------------------------------------------
// K6: backward dh. CTA = 128 rows x VS vocab columns: dl [128][VS] in
// shared memory (rounded to W's dtype), then for each 128-wide chunk of H,
// dh32[rows, chunk] += dl W[chunk, cols]^T with red.global.add.f32.
// ---------------------------------------------------------------------------
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fce_bwd_dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const int* __restrict__ labels, int offset,
                      const float* __restrict__ lse,
                      const float* __restrict__ gr, float* __restrict__ dh32,
                      int N, int H, int V) {
  using L = Lay<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  T* dl = stage + 2 * L::STAGE;  // [128][PD]
  const Lane ln;
  const int r0 = blockIdx.x * kTile;
  const int vg0 = blockIdx.y * L::VS;
  const int width = min(L::VS, V - vg0);
  RowsIn in;
  in.load(lse, gr, labels, offset, r0, N, ln);

  float acc[2][8][4];
  for (int j = 0; j * kTile < width; ++j) {
    s_tile<T, VEC>(acc, h, w, stage, r0, vg0 + j * kTile, N, H, V, ln);
    cotangent<T>(acc, in, vg0 + j * kTile, V, ln, [&](int rl, int cl, T x) {
      dl[rl * L::PD + j * kTile + cl] = x;
    });
  }
  const int nk = (width + L::KC - 1) / L::KC;
  for (int hc = 0; hc < H; hc += kTile) {
    zero(acc);
    pipeline(
        nk,
        [&](int i, int s) {
          load_tile<T, kTile, L::KC, L::PK, VEC>(
              stage + s * L::STAGE, w, V, hc, vg0 + i * L::KC, H, V);
        },
        [&](int i, int s) {
          warp_product<T, true, L::PD, true, L::PK>(
              acc, dl + i * L::KC, stage + s * L::STAGE, ln.wm, ln.wn,
              ln.g, ln.t);
        });
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + ln.row(mt * 2 + (e >> 1));
          const int c = hc + ln.col(nt, e);
          if (r < N && c < H) {
            atomicAdd(dh32 + (size_t)r * H + c, acc[mt][nt][e]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7: backward dW. CTA = VS rows x 128 vocab columns: dl^T [128][VS] in
// shared memory (rounded to h's dtype), then for each 128-wide chunk of H,
// dW32[chunk, cols] += h[rows, chunk]^T dl with red.global.add.f32.
// ---------------------------------------------------------------------------
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fce_bwd_dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      const int* __restrict__ labels, int offset,
                      const float* __restrict__ lse,
                      const float* __restrict__ gr, float* __restrict__ dw32,
                      int N, int H, int V) {
  using L = Lay<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  T* dlt = stage + 2 * L::STAGE;  // [128 columns][PD rows]
  const Lane ln;
  const int v0 = blockIdx.x * kTile;
  const int rg0 = blockIdx.y * L::VS;
  const int height = min(L::VS, N - rg0);

  float acc[2][8][4];
  for (int i = 0; i * kTile < height; ++i) {
    const int r0 = rg0 + i * kTile;
    RowsIn in;
    in.load(lse, gr, labels, offset, r0, N, ln);
    s_tile<T, VEC>(acc, h, w, stage, r0, v0, N, H, V, ln);
    cotangent<T>(acc, in, v0, V, ln, [&](int rl, int cl, T x) {
      dlt[cl * L::PD + i * kTile + rl] = x;
    });
  }
  const int nk = (height + L::KC - 1) / L::KC;
  for (int hc = 0; hc < H; hc += kTile) {
    zero(acc);
    pipeline(
        nk,
        [&](int i, int s) {
          load_tile<T, L::KC, kTile, L::PT, VEC>(
              stage + s * L::STAGE, h, H, rg0 + i * L::KC, hc, N, H);
        },
        [&](int i, int s) {
          warp_product<T, false, L::PT, true, L::PD>(
              acc, stage + s * L::STAGE, dlt + i * L::KC, ln.wm, ln.wn,
              ln.g, ln.t);
        });
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = hc + ln.row(mt * 2 + (e >> 1));
          const int c = v0 + ln.col(nt, e);
          if (r < H && c < V) {
            atomicAdd(dw32 + (size_t)r * V + c, acc[mt][nt][e]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6 and K7 on Hopper: bfloat16 / float16 with H and V multiples of 8 (rows
// of 16 bytes, as TMA needs), the training path. 384 threads: warpgroups 0
// and 1 consume, warpgroup 2 produces (setmaxnreg 232 / 40). One producer
// thread streams every operand tile with TMA (2-D maps, 128-byte swizzle)
// through a ring of kWsStages 32 KB stages (full barrier on the bytes,
// empty barrier on the 256 consumer threads), in exactly the order the
// consumers take them. Two phases per CTA, the accumulators of the two
// never live at once:
//   phase 1: s tiles of 128 rows x 128 vocab columns, s = h W over H in
//     64-deep stages (h box [128 rows x 64] K-major; W boxes [64 x 64]
//     twice, N-contiguous, so the B descriptor is MN-major: wgmma's
//     transpose bit, as V in K2); each consumer warpgroup owns 64 rows and
//     keeps one product group in flight behind the one it issues. Then dl
//     = (exp(s - lse) - onehot) g, rounded to the 16-bit type, is written
//     into a resident [128 x 512] (K6) or [512 x 128] (K7) tile in the
//     swizzled layout wgmma reads (wgmma.cuh), behind a proxy fence;
//   phase 2, K6: for each 128-wide chunk of H, acc[64 rows x 128] per
//     warpgroup = dl W[chunk, slice]^T: A is the resident dl (K-major), B
//     the W boxes [128 H rows x 64 vocab] (K-major), 128 vocab deep a stage;
//   phase 2, K7: for each 128-wide chunk of H, acc[64 H x 128 vocab] per
//     warpgroup = h[slice, chunk]^T dl: A is the h boxes [128 rows x 64 H],
//     M-contiguous (transpose bit on A), B the resident dl (N-contiguous,
//     transpose bit on B), 128 rows deep a stage;
//   epilogue: each thread pairs its two columns with its neighbour lane's
//     and adds four consecutive fp32 values with one red.global.add.v4.f32
//     into the zeroed [N, H] / [H, V] buffer (a quarter of the reductions
//     of per-element atomics; the sum order still varies run to run:
//     a cluster cannot hold the slice, 128 x 4096 fp32 = 2 MB against the
//     8 x 227 KB of a portable cluster).
//   raster: K6's CTAs run in groups of kGroupRows row blocks x every vocab
//     slice, K7's row slices of one vocab tile one after the other, so the
//     CTAs in flight share their W slices and add into a few MB of the fp32
//     buffer, which then stays in L2 (K7's [H, V] buffer is 524 MB at the
//     training shape: with the vocab tile as the fast index its reductions
//     missed L2 and K7 took 8.2 ms instead of 5.2).
// Shared memory: the dl tile (128 KB), the ring (kWsStages x 32 KB), the
// barriers: 230 KB with three stages. The ring bounds the speed: one stage
// is being read, one finishing its products, so one loads ahead; two
// stages (no load ahead) took 6.8 / 7.1 ms instead of 4.8 / 5.2, while
// narrower slices for a deeper ring (384 x 4 stages, 256 x 5) lost more to
// the extra reductions than they gained (H100 80GB HBM3 at 700 W;
// PERF.md).
// ---------------------------------------------------------------------------
constexpr int kWsThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumers = 256;
constexpr int kWsStages = 3;
constexpr uint32_t kStageBytes = 32768;
constexpr int kSlice = 512;  // K6's vocab columns, K7's rows per CTA
constexpr int kGroupRows = 8;  // K6's row blocks per raster group
constexpr uint32_t kDlBytes = 128 * kSlice * 2;
constexpr size_t kWsSmem =
    1024 + kDlBytes + (size_t)kWsStages * kStageBytes + 16 * kWsStages;

struct WsRing {
  uint32_t ring0, full0, empty0;
  __device__ uint32_t stage(int s) const { return ring0 + s * kStageBytes; }
};

// Producer: wait until stage `it` of the sequence is free, arm its full
// barrier for 32 KB, return its address (and the barrier in `full`).
__device__ __forceinline__ uint32_t ws_produce(const WsRing& r, int it,
                                               uint32_t& full) {
  const Ring<kWsStages> q(it);
  mbar_wait(r.empty0 + 8 * q.s, q.phase ^ 1);
  full = r.full0 + 8 * q.s;
  mbar_expect_tx(full, kStageBytes);
  return r.stage(q.s);
}

// Producer, phase 1: the nk stages of one s tile (rows r0.., columns v0..).
__device__ __forceinline__ void ws_load_s_tile(const WsRing& r, int& it,
                                               const CUtensorMap* th,
                                               const CUtensorMap* tw, int r0,
                                               int v0, int nk) {
  for (int ks = 0; ks < nk; ++ks, ++it) {
    uint32_t full;
    const uint32_t st = ws_produce(r, it, full);
    tma_load_2d(st, th, full, ks * 64, r0);
    tma_load_2d(st + 16384, tw, full, v0, ks * 64);
    tma_load_2d(st + 24576, tw, full, v0 + 64, ks * 64);
  }
}

// Consumer: wait for stage `it`; release the one before it.
__device__ __forceinline__ uint32_t ws_acquire(const WsRing& r, int it) {
  const Ring<kWsStages> q(it);
  mbar_wait(r.full0 + 8 * q.s, q.phase);
  return r.stage(q.s);
}

__device__ __forceinline__ void ws_release(const WsRing& r, int it) {
  mbar_arrive(r.empty0 + 8 * Ring<kWsStages>(it).s);
}

// Consumer, phase 1: warpgroup wg's 64 rows x 128 columns of s = h W in
// fp32, one product group in flight behind the one being issued.
template <typename T>
__device__ __forceinline__ void ws_s_tile(float (&s)[64], const WsRing& r,
                                          int& it, int nk, int wg) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  for (int ks = 0; ks < nk; ++ks, ++it) {
    const uint32_t st = ws_acquire(r, it);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wg<T>::template ss128x<0, 1>(
          s, sw128_desc(st + wg * 64 * 128 + kk * 32, 16),
          sw128_desc(st + 16384 + kk * 16 * 128, 8192));
    }
    wg_commit();
    wg_wait<1>();
    if (ks > 0) ws_release(r, it - 1);
  }
  wg_wait<0>();
  wg_hold<64>(s);
  if (nk > 0) ws_release(r, it - 1);
}

// dl of the s tile in `s` (rows rl, columns cl as the fragment layout gives
// them; rw: this lane's two rows' lse, g and local label), rounded and
// stored as a packed pair at (row, col) of a dl tile whose 64-column halves
// are `half` bytes apart. Columns at or past V carry nothing.
template <typename T>
__device__ __forceinline__ void ws_store_dl(const float (&s)[64],
                                            uint32_t dl0, uint32_t half,
                                            int row0, int col0, int v0,
                                            int V, const float (&lse)[2],
                                            const float (&g)[2],
                                            const int (&lab)[2], int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr, col = col0 + 8 * j + 2 * t;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + 8 * j + 2 * t + e;
        x[e] = v < V ? (expf(s[4 * j + 2 * rr + e] - lse[rr]) -
                        (v == lab[rr] ? 1.f : 0.f)) *
                           g[rr]
                     : 0.f;
      }
      const uint32_t a = dl0 + (col >> 6) * half + row * 128 +
                         ((((col & 63) >> 3) ^ (row & 7)) << 4) +
                         (col & 7) * 2;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a),
                   "r"(pack2<T>(x[0], x[1]))
                   : "memory");
    }
  }
}

// dl's generic-proxy stores visible to the consumers' wgmma reads.
__device__ __forceinline__ void ws_publish_dl() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// out[row, col..col+3] += four fp32 values of a 64 x 128 accumulator, rows
// r0 + warp-local rows, columns c0 + ..., within R x C (C a multiple of 8).
__device__ __forceinline__ void ws_red_add(const float (&acc)[64],
                                           float* __restrict__ out,
                                           size_t ld, int r0, int c0, int R,
                                           int C, int g, int t) {
  const bool odd = t & 1;
  const int row = r0 + g + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float o0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float o1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const int col = c0 + 8 * j + 2 * (t & ~1);
    float4 v;
    if (odd) {
      v = make_float4(o0, o1, acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      v = make_float4(acc[4 * j], acc[4 * j + 1], o0, o1);
    }
    if (row < R && col < C) {
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                       out + (size_t)row * ld + col),
                   "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                   : "memory");
    }
  }
}

// K6 on Hopper: CTA = 128 rows x kSlice vocab columns (N/128 x V/kSlice
// CTAs), dh32 [N, H] += dl W^T.
template <typename T>
__global__ void __launch_bounds__(kWsThreads, 1)
    fce_bwd_dh_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                            const __grid_constant__ CUtensorMap tw,
                            const int* __restrict__ labels, int offset,
                            const float* __restrict__ lse,
                            const float* __restrict__ gr,
                            float* __restrict__ dh32, int N, int H, int V) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t dl0 = (smem_u32(smem) + 1023) & ~1023u;
  WsRing r;
  r.ring0 = dl0 + kDlBytes;
  r.full0 = r.ring0 + kWsStages * kStageBytes;
  r.empty0 = r.full0 + 8 * kWsStages;
  // Grouped raster: consecutive CTAs take kGroupRows row blocks x the
  // vocab slices, so those in flight share W slices and add into a few MB
  // of dh32 that stay in L2.
  const int nrb = (N + 127) / 128, nvs = (V + kSlice - 1) / kSlice;
  const int grp = blockIdx.x / (kGroupRows * nvs);
  const int gsz = min(kGroupRows, nrb - grp * kGroupRows);
  const int in_grp = blockIdx.x - grp * kGroupRows * nvs;
  const int r0 = (grp * kGroupRows + in_grp % gsz) * 128;
  const int vg0 = (in_grp / gsz) * kSlice;
  const int nt = (min(kSlice, V - vg0) + 127) / 128;  // s tiles, 128 wide
  const int nk = (H + 63) / 64, nh = (H + 127) / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWsStages; ++i) {
      mbar_init(r.full0 + 8 * i, 1);
      mbar_init(r.empty0 + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int it = 0;
      for (int j = 0; j < nt; ++j) {
        ws_load_s_tile(r, it, &th, &tw, r0, vg0 + j * 128, nk);
      }
      for (int hc = 0; hc < nh; ++hc) {
        for (int vs = 0; vs < nt; ++vs, ++it) {
          uint32_t full;
          const uint32_t st = ws_produce(r, it, full);
          for (int c = 0; c < 2; ++c) {
            for (int rh = 0; rh < 2; ++rh) {
              tma_load_2d(st + c * 16384 + rh * 8192, &tw, full,
                          vg0 + vs * 128 + c * 64, hc * 128 + rh * 64);
            }
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows [r0 + 64 wg, r0 + 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl = wg * 64 + warp * 16 + g;  // this lane's rows: rl, rl + 8
    float ls[2], gv[2];
    int lab[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + rl + 8 * rr;
      const bool in = row < N;
      ls[rr] = in ? lse[row] : 0.f;
      gv[rr] = in ? gr[row] : 0.f;
      lab[rr] = in ? labels[row] - offset : -1;
    }
    int it = 0;
    float acc[64];
    for (int j = 0; j < nt; ++j) {
      ws_s_tile<T>(acc, r, it, nk, wg);
      ws_store_dl<T>(acc, dl0, 128 * 128, rl, j * 128, vg0 + j * 128, V, ls,
                     gv, lab, t);
    }
    ws_publish_dl();
    for (int hc = 0; hc < nh; ++hc) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int vs = 0; vs < nt; ++vs, ++it) {
        const uint32_t st = ws_acquire(r, it);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t a = dl0 + (vs * 2 + (kk >> 2)) * (128 * 128) +
                             wg * 64 * 128 + (kk & 3) * 32;
          Wg<T>::template ss128x<0, 0>(
              acc, sw128_desc(a, 16),
              sw128_desc(st + (kk >> 2) * 16384 + (kk & 3) * 32, 16));
        }
        wg_commit();
        wg_wait<1>();
        if (vs > 0) ws_release(r, it - 1);
      }
      wg_wait<0>();
      wg_hold<64>(acc);
      ws_release(r, it - 1);
      ws_red_add(acc, dh32, H, r0 + wg * 64 + warp * 16, hc * 128, N, H, g,
                 t);
    }
  }
}

// K7 on Hopper: CTA = 128 vocab columns x kSlice rows (V/128 x N/kSlice
// CTAs), dW32 [H, V] += h^T dl.
template <typename T>
__global__ void __launch_bounds__(kWsThreads, 1)
    fce_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                            const __grid_constant__ CUtensorMap tw,
                            const int* __restrict__ labels, int offset,
                            const float* __restrict__ lse,
                            const float* __restrict__ gr,
                            float* __restrict__ dw32, int N, int H, int V) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t dl0 = (smem_u32(smem) + 1023) & ~1023u;
  WsRing r;
  r.ring0 = dl0 + kDlBytes;
  r.full0 = r.ring0 + kWsStages * kStageBytes;
  r.empty0 = r.full0 + 8 * kWsStages;
  // The row slices of a vocab tile are consecutive CTAs: those in flight
  // add into a few vocab tiles' 2 MB column blocks of dw32 (524 MB at the
  // training shape), which stay in L2, and share their W columns.
  const int nrs = (N + kSlice - 1) / kSlice;
  const int v0 = (blockIdx.x / nrs) * 128;
  const int rg0 = (blockIdx.x % nrs) * kSlice;
  const int nt = (min(kSlice, N - rg0) + 127) / 128;  // s tiles, 128 high
  const int nk = (H + 63) / 64, nh = (H + 127) / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWsStages; ++i) {
      mbar_init(r.full0 + 8 * i, 1);
      mbar_init(r.empty0 + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int it = 0;
      for (int i = 0; i < nt; ++i) {
        ws_load_s_tile(r, it, &th, &tw, rg0 + i * 128, v0, nk);
      }
      for (int hc = 0; hc < nh; ++hc) {
        for (int rs = 0; rs < nt; ++rs, ++it) {
          uint32_t full;
          const uint32_t st = ws_produce(r, it, full);
          tma_load_2d(st, &th, full, hc * 128, rg0 + rs * 128);
          tma_load_2d(st + 16384, &th, full, hc * 128 + 64, rg0 + rs * 128);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns 64 rows of each s tile, then
            // H rows [hc + 64 wg, hc + 64 wg + 64) of each dW chunk
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl = wg * 64 + warp * 16 + g;
    int it = 0;
    float acc[64];
    for (int i = 0; i < nt; ++i) {
      float ls[2], gv[2];
      int lab[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = rg0 + i * 128 + rl + 8 * rr;
        const bool in = row < N;
        ls[rr] = in ? lse[row] : 0.f;
        gv[rr] = in ? gr[row] : 0.f;
        lab[rr] = in ? labels[row] - offset : -1;
      }
      ws_s_tile<T>(acc, r, it, nk, wg);
      ws_store_dl<T>(acc, dl0, kSlice * 128, i * 128 + rl, 0, v0, V, ls, gv,
                     lab, t);
    }
    ws_publish_dl();
    for (int hc = 0; hc < nh; ++hc) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int rs = 0; rs < nt; ++rs, ++it) {
        const uint32_t st = ws_acquire(r, it);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          Wg<T>::template ss128x<1, 1>(
              acc, sw128_desc(st + wg * 16384 + kk * 16 * 128, 16384),
              sw128_desc(dl0 + (rs * 128 + kk * 16) * 128, kSlice * 128));
        }
        wg_commit();
        wg_wait<1>();
        if (rs > 0) ws_release(r, it - 1);
      }
      wg_wait<0>();
      wg_hold<64>(acc);
      ws_release(r, it - 1);
      ws_red_add(acc, dw32, V, hc * 128 + wg * 64 + warp * 16, v0, H, V, g,
                 t);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------
struct Args {
  const void *h, *w;
  const int* labels;
  int offset, N, H, V;
};

template <typename T>
bool vec_ok(const Args& a) {
  constexpr int E = 16 / sizeof(T);
  return a.H % E == 0 && a.V % E == 0 &&
         reinterpret_cast<uintptr_t>(a.h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
}

template <typename T, bool VEC>
cudaError_t fwd(const Args& a, float* part, float* m, float* l, float* z,
                int splits, cudaStream_t st) {
  constexpr size_t smem = 2 * (size_t)Lay<T>::STAGE * sizeof(T);
  auto kernel = fce_fwd_kernel<T, VEC>;
  static bool done = false;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  const int nvt = (a.V + kTile - 1) / kTile;
  const int tps = (nvt + splits - 1) / splits;
  const dim3 grid((a.N + kTile - 1) / kTile, (nvt + tps - 1) / tps);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.h), static_cast<const T*>(a.w), a.labels,
      a.offset, part, a.N, a.H, a.V, tps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fce_merge_kernel<<<(a.N + 255) / 256, 256, 0, st>>>(part, m, l, z, a.N,
                                                      (int)grid.y);
  return cudaGetLastError();
}

// K6 / K7 on Hopper (16-bit types, H and V multiples of 8).
template <typename T, bool DH>
cudaError_t bwd_wgmma(const Args& a, const float* lse, const float* g,
                      float* out, cudaStream_t st) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap th, tw;
  if (!matrix_map(&th, a.h, type, 2, a.N, a.H, 64, 128,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !matrix_map(&tw, a.w, type, 2, a.H, a.V, 64, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = DH ? fce_bwd_dh_wgmma_kernel<T> : fce_bwd_dw_wgmma_kernel<T>;
  static bool done = false;
  const cudaError_t e = allow_smem(kernel, kWsSmem, done);
  if (e != cudaSuccess) return e;
  const int ctas = DH ? ((a.N + 127) / 128) * ((a.V + kSlice - 1) / kSlice)
                       : ((a.V + 127) / 128) * ((a.N + kSlice - 1) / kSlice);
  kernel<<<ctas, kWsThreads, kWsSmem, st>>>(th, tw, a.labels, a.offset, lse,
                                            g, out, a.N, a.H, a.V);
  return cudaGetLastError();
}

template <typename T, bool VEC, bool DH>
cudaError_t bwd(const Args& a, const float* lse, const float* g, float* out,
                cudaStream_t st) {
  if constexpr (sizeof(T) == 2 && VEC) {
    return bwd_wgmma<T, DH>(a, lse, g, out, st);
  } else {
    using L = Lay<T>;
    constexpr size_t smem =
        (2 * (size_t)L::STAGE + (size_t)kTile * L::PD) * sizeof(T);
    auto kernel = DH ? fce_bwd_dh_kernel<T, VEC> : fce_bwd_dw_kernel<T, VEC>;
    static bool done = false;
    cudaError_t e = allow_smem(kernel, smem, done);
    if (e != cudaSuccess) return e;
    const dim3 grid = DH ? dim3((a.N + kTile - 1) / kTile,
                                (a.V + L::VS - 1) / L::VS)
                         : dim3((a.V + kTile - 1) / kTile,
                                (a.N + L::VS - 1) / L::VS);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(a.h), static_cast<const T*>(a.w), a.labels,
        a.offset, lse, g, out, a.N, a.H, a.V);
    return cudaGetLastError();
  }
}

bool bad(const Args& a) {
  return a.N <= 0 || a.H <= 0 || a.V <= 0 ||
         (a.N + kTile - 1) / kTile > 65535 || (a.V + kTile - 1) / kTile > 65535;
}

template <typename F>
cudaError_t by_dtype(int dtype, const Args& a, F f) {
  switch (dtype) {
    case 0:
      return vec_ok<float>(a) ? f(float{}, std::true_type{})
                              : f(float{}, std::false_type{});
    case 1:
      return vec_ok<__half>(a) ? f(__half{}, std::true_type{})
                               : f(__half{}, std::false_type{});
    case 2:
      return vec_ok<__nv_bfloat16>(a)
                 ? f(__nv_bfloat16{}, std::true_type{})
                 : f(__nv_bfloat16{}, std::false_type{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (h and W alike). Pointers
// are device pointers to contiguous h [N, H], W [H, V], labels [N] int32,
// lse / g [N] fp32. Each returns the cudaError_t of its launches (0 = ok).

// K5: part is fp32 [3, splits, N] scratch; m, l, z are fp32 [N].
extern "C" int pt_fused_ce_fwd(const void* h, const void* w,
                               const void* labels, int offset, void* part,
                               void* m, void* l, void* z, int N, int H, int V,
                               int splits, int dtype, void* stream) {
  const Args a{h, w, static_cast<const int*>(labels), offset, N, H, V};
  if (bad(a) || splits <= 0 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *pp = static_cast<float*>(part), *mp = static_cast<float*>(m),
        *lp = static_cast<float*>(l), *zp = static_cast<float*>(z);
  return static_cast<int>(by_dtype(dtype, a, [&](auto t, auto vec) {
    return fwd<decltype(t), decltype(vec)::value>(a, pp, mp, lp, zp, splits,
                                                   st);
  }));
}

// K6: dh32 is a zeroed fp32 [N, H] buffer that receives dh.
extern "C" int pt_fused_ce_bwd_dh(const void* h, const void* w,
                                  const void* labels, int offset,
                                  const void* lse, const void* g, void* dh32,
                                  int N, int H, int V, int dtype,
                                  void* stream) {
  const Args a{h, w, static_cast<const int*>(labels), offset, N, H, V};
  if (bad(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, a, [&](auto t, auto vec) {
    return bwd<decltype(t), decltype(vec)::value, true>(
        a, static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<float*>(dh32), st);
  }));
}

// K7: dw32 is a zeroed fp32 [H, V] buffer that receives dW.
extern "C" int pt_fused_ce_bwd_dw(const void* h, const void* w,
                                  const void* labels, int offset,
                                  const void* lse, const void* g, void* dw32,
                                  int N, int H, int V, int dtype,
                                  void* stream) {
  const Args a{h, w, static_cast<const int*>(labels), offset, N, H, V};
  if (bad(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, a, [&](auto t, auto vec) {
    return bwd<decltype(t), decltype(vec)::value, false>(
        a, static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<float*>(dw32), st);
  }));
}
