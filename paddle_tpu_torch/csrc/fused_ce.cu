// Fused linear + softmax cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/fused_ce.py:
//   K5 _fwd_kernel    (via _fwd_partials, :104) -> fce_fwd_kernel and
//                                                  fce_merge_kernel
//   K6 _bwd_dh_kernel (via _bwd_impl, :192)     -> fce_bwd_dh_kernel
//   K7 _bwd_dw_kernel (via _bwd_impl, :207)     -> fce_bwd_dw_kernel
// h is [N, H], W is [H, V] (Paddle's [in, out] layout), labels [N] int32,
// all contiguous; s = h W is never written to memory. Ragged N, H and V are
// masked here (no padding in memory); offsets into h, W and the fp32
// accumulators are 64-bit.
//
// Bound: operations. At the training shape (N = 4096, H = 4096, V = 32000,
// bf16) K5 does 2NHV = 1.07e12 flops (1.09 ms at 989 TFLOP/s), K6 and K7
// 4NHV each (s recomputed, then the product): 2.17 ms. W alone is 262 MB,
// 0.08 ms at 3.35 TB/s. Design, common to all three:
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
// wgmma, TMA and a deterministic cluster reduction are later work.
//
// Semantics kept from the Pallas kernels: s in fp32; columns >= V are
// -1e30 and carry no probability; z is the fp32 logit at the label, 0 when
// label - vocab_offset is outside [0, V); dl is rounded to W's dtype before
// dl W^T (K6) and to h's dtype before h^T dl (K7); rows with g = 0 (and
// rows >= N) add nothing.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// Launchers.
// ---------------------------------------------------------------------------
struct Args {
  const void *h, *w;
  const int* labels;
  int offset, N, H, V;
};

// Raise a kernel's dynamic shared-memory limit once per instance (`done`
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

template <typename T, bool VEC, bool DH>
cudaError_t bwd(const Args& a, const float* lse, const float* g, float* out,
                cudaStream_t st) {
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
