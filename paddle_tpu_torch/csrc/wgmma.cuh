// Hopper warpgroup matrix multiply (wgmma) helpers shared by the port's
// kernels: shared-memory descriptors of 128-byte-swizzled tiles, the fence /
// commit / wait protocol, and m64nNk16 products of 16-bit operands with fp32
// accumulators (A from shared memory or registers, either operand K-major or
// MN-major through the transpose bits).
//
// Tiles are laid out as TMA writes them with 128-byte swizzle: rows of 64
// 16-bit elements (128 bytes), 8-row groups of 1024 bytes, the 16-byte
// chunks of a row XOR-ed with the row's index mod 8; a tile wider than 64
// elements is several such "halves" one after the other. Every tile starts
// on a 1024-byte boundary. Accumulators are in the m16n8 fragment layout per
// warp: lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 of its
// warp's 16, columns 2t and 2t + 1 of every 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Two fp32 values rounded to the 16-bit type, packed into one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// wgmma shared-memory descriptor of a swizzled tile at `addr`: 8-row
// groups 1024 bytes apart (stride byte offset), 128-byte swizzle. K-major
// (the reduction index runs along the row): `lbo` is unused (16). MN-major
// (a row is one reduction index, 64 output columns): the next 64 columns
// start `lbo` bytes on, in the next half.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Commit the warpgroup's products issued since the last commit and wait
// for all of them.
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Commit the products issued since the last commit as one group; wait
// until at most N groups are still in flight.
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving a register that an asynchronous wgmma
// reads or writes across the wait.
template <int N>
__device__ __forceinline__ void wg_hold(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wg_hold(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

#define PT_WG_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31"

#define PT_WG_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define PT_WG_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63"

#define PT_WG_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define PT_WG_D128 \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63," \
  "%64, %65, %66, %67, %68, %69, %70, %71," \
  "%72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87," \
  "%88, %89, %90, %91, %92, %93, %94, %95," \
  "%96, %97, %98, %99, %100, %101, %102, %103," \
  "%104, %105, %106, %107, %108, %109, %110, %111," \
  "%112, %113, %114, %115, %116, %117, %118, %119," \
  "%120, %121, %122, %123, %124, %125, %126, %127"

#define PT_WG_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])


// d[64 x N] += A[64 x 16] B[16 x N] for one warpgroup, fp32 accumulate.
// ss: A and B from shared memory, both K-major; ss128x<TA, TB> and
// ss256x<TA, TB> (N = 256, 128 accumulators a thread): A and B from shared
// memory, each MN-major where its transpose bit is 1. rs: A
// from registers (the m16n8k16 A fragment of each warp's 16 rows), B from
// shared memory MN-major (transpose bit set). A product starts from zeroed accumulators,
// not from wgmma's scale-d = 0: with an unset accumulator as the asm's
// input, ptxas spills and serialises the wgmma pipeline.
#define PT_WG_OPS(T, TY)                                                      \
  template <>                                                                 \
  struct Wg<T> {                                                              \
    __device__ __forceinline__ static void ss64(float* d, uint64_t a,         \
                                                uint64_t b) {                 \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
          "{" PT_WG_D32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                    \
          : PT_WG_OUT32(d)                                                    \
          : "l"(a), "l"(b), "r"(1));                                          \
    }                                                                         \
    __device__ __forceinline__ static void ss128(float* d, uint64_t a,        \
                                                 uint64_t b) {                \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
          "{" PT_WG_D64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                    \
          : PT_WG_OUT64(d)                                                    \
          : "l"(a), "l"(b), "r"(1));                                          \
    }                                                                         \
    template <int TA, int TB>                                                 \
    __device__ __forceinline__ static void ss128x(float* d, uint64_t a,       \
                                                  uint64_t b) {               \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
          "{" PT_WG_D64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                \
          : PT_WG_OUT64(d)                                                    \
          : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));                        \
    }                                                                         \
    template <int TA, int TB>                                                 \
    __device__ __forceinline__ static void ss256x(float* d, uint64_t a,       \
                                                  uint64_t b) {               \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "        \
          "{" PT_WG_D128 "}, %128, %129, p, 1, 1, %131, %132;\n}\n"          \
          : PT_WG_OUT128(d)                                                   \
          : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));                        \
    }                                                                         \
    __device__ __forceinline__ static void rs64(float* d, const uint32_t* a,  \
                                                uint64_t b) {                 \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
          "{" PT_WG_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"      \
          : PT_WG_OUT32(d)                                                    \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));      \
    }                                                                         \
    __device__ __forceinline__ static void rs128(float* d,                    \
                                                 const uint32_t* a,           \
                                                 uint64_t b) {                \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
          "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
          "{" PT_WG_D64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"      \
          : PT_WG_OUT64(d)                                                    \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));      \
    }                                                                         \
  };

template <typename T>
struct Wg;
PT_WG_OPS(__nv_bfloat16, "bf16")
PT_WG_OPS(__half, "f16")

template <typename T, int N>
__device__ __forceinline__ void wg_ss(float* d, uint64_t a, uint64_t b) {
  if constexpr (N == 64) {
    Wg<T>::ss64(d, a, b);
  } else {
    Wg<T>::ss128(d, a, b);
  }
}

template <typename T, int N>
__device__ __forceinline__ void wg_rs(float* d, const uint32_t* a,
                                      uint64_t b) {
  if constexpr (N == 64) {
    Wg<T>::rs64(d, a, b);
  } else {
    Wg<T>::rs128(d, a, b);
  }
}

// The A fragments of P (or dS) for the next product, from a 64 x (8 NT)
// accumulator: k-step kk takes n-tiles 2kk and 2kk + 1. Packing to 16 bits
// is where the Pallas kernels' cast to the input dtype happens.
template <typename T, int NT>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

}  // namespace
