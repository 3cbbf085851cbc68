// Multi-tensor optimizer kernels for Hopper (sm_90a): U1 and U2.
//
// U1 pt_multi_tensor_sumsq_finite: over a list of grads, each optionally
//    multiplied by a device scalar inv_scale (rounded to the grad's dtype,
//    the product rounded too), the fp32 sum of squares of every tensor, the
//    sum of those in list order, and one flag for whether every element
//    was finite. One launch for up to kSumsqMax tensors.
// U2 pt_multi_tensor_adam: the Adam / AdamW rule of
//    paddle_tpu/optimizer/optimizers.py:63-76 over lists p, g, m, v of one
//    dtype, in place, with optional device scalars inv_scale and clip_scale
//    multiplied into the grads first, and a device flag under which nothing
//    is written. The learning rate (fp32) and the step count (int32) are
//    read from 0-dim device tensors, and the bias corrections 1 - beta**t
//    are taken from them on the card (powf in fp32, as the plain rule's
//    torch.pow and the JAX rule's float32 power), so a CUDA graph that
//    holds the launch reads the values written before each replay. One
//    launch for up to kAdamMax tensors.
//
// Neither replaces a Pallas kernel. In the JAX package XLA fuses this work
// into one program: the optimizer's one jitted update
// (paddle_tpu/optimizer/optimizer.py:81-97) and the clip, finite flag and
// update inside the train steps (paddle_tpu/models/llama.py:886-913,
// paddle_tpu/parallel/trainer.py:329-373). No PyTorch call computes the
// reference's rule, so the port writes the fused pass by hand.
//
// Bound: both are streaming passes, bound by device-memory bytes. U1 reads
// each grad once (4 B an fp32 element); U2 reads p, g, m, v and writes p,
// m, v (28 B an fp32 element). The design does what that asks and no more:
// the tensors' pointers ride in the kernel's parameter space
// (__grid_constant__, read from the constant bank, no device copy, so a
// launch is capturable in a CUDA graph), each CTA streams one kChunk slice
// of one tensor with 16-byte loads where all of that tensor's pointers are
// 16-byte aligned (element loads otherwise and for the tail), and nothing
// is staged in shared memory.
//
// Numbers. Every op is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an FMA;
// in bf16 and fp16 each op's result is rounded to the dtype, as PyTorch's
// per-op rule rounds it. U2 thus equals multi_tensor_adam_ref
// (ops/kernels/multi_tensor.py) bit for bit. U1 is deterministic: each CTA
// writes its slice's partial sum and finite flag, the last CTA to finish
// (an integer counter, no float atomics) adds each tensor's partials in a
// fixed order and then the tensors' sums in list order, so the same grads
// give the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 1LL << 16;  // elements of one tensor per CTA
// Tensors per launch, so that a table stays under 4 KB of parameters.
constexpr int kSumsqMax = 128;
constexpr int kAdamMax = 80;

// dtype codes: ops/kernels/flash_attention.py's _DTYPE_CODE
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float to(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <>
struct Num<__half> {
  static __device__ __forceinline__ float to(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from(float x) {
    return __float2half_rn(x);
  }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

// x rounded to T and back: one op's result as PyTorch stores it in T.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Num<T>::to(Num<T>::from(x));
}

// The tensor whose chunks hold CTA `block`: the largest t with
// start[t] <= block (tensors with no chunk are skipped over).
__device__ __forceinline__ int find_tensor(const int* start, int count,
                                           int block) {
  int lo = 0, hi = count;  // start[lo] <= block < start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= block) lo = mid; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// U1: sum of squares and finite flag
// ---------------------------------------------------------------------------

struct SumsqTable {
  const void* g[kSumsqMax];
  long long n[kSumsqMax];
  int start[kSumsqMax + 1];  // first chunk (CTA) of each tensor
  unsigned char dtype[kSumsqMax];
  int count;
};

template <typename T>
__device__ __forceinline__ void sumsq_elem(T e, bool has_inv, float inv,
                                           float& acc, bool& bad) {
  float x = Num<T>::to(e);
  if (has_inv) x = rnd<T>(__fmul_rn(x, inv));
  bad |= !isfinite(x);
  acc = __fmaf_rn(x, x, acc);
}

// Elements [lo, hi) of g into this thread's partial sum; lo is a multiple
// of kChunk, so a 16-byte aligned tensor stays aligned at lo.
template <typename T>
__device__ void sumsq_range(const T* __restrict__ g, long long lo,
                            long long hi, bool has_inv, float inv_in,
                            float& acc_out, bool& bad) {
  constexpr int VEC = 16 / sizeof(T);
  const float inv = rnd<T>(inv_in);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  long long i = lo;
  if (reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    const long long vend = lo + (hi - lo) / VEC * VEC;
    for (long long j = lo + threadIdx.x * VEC; j < vend;
         j += kThreads * VEC) {
      uint4 raw = __ldcs(reinterpret_cast<const uint4*>(g + j));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) sumsq_elem<T>(e[k], has_inv, inv, acc[k],
                                                   bad);
    }
    i = vend;
  }
  for (long long j = i + threadIdx.x; j < hi; j += kThreads)
    sumsq_elem<T>(g[j], has_inv, inv, acc[0], bad);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) s = __fadd_rn(s, acc[k]);
  acc_out = s;
}

// Sum over the CTA in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, sh[w]);
  return s;
}

__global__ void __launch_bounds__(kThreads) sumsq_finite_kernel(
    const __grid_constant__ SumsqTable tab, const float* __restrict__ inv,
    float* __restrict__ part_sum, int* __restrict__ part_bad,
    unsigned int* __restrict__ counter, float* __restrict__ sumsq,
    float* __restrict__ total, int* __restrict__ finite, int first) {
  __shared__ float sh[kThreads / 32];
  __shared__ bool is_last;
  const int b = blockIdx.x;
  float acc = 0.f;
  bool bad = false;
  if (b < tab.start[tab.count]) {
    const int t = find_tensor(tab.start, tab.count, b);
    const long long lo = static_cast<long long>(b - tab.start[t]) * kChunk;
    const long long hi = min(lo + kChunk, tab.n[t]);
    const bool has_inv = inv != nullptr;
    const float iv = has_inv ? *inv : 1.f;
    switch (tab.dtype[t]) {
      case kF32:
        sumsq_range<float>(static_cast<const float*>(tab.g[t]), lo, hi,
                           has_inv, iv, acc, bad);
        break;
      case kF16:
        sumsq_range<__half>(static_cast<const __half*>(tab.g[t]), lo, hi,
                            has_inv, iv, acc, bad);
        break;
      default:
        sumsq_range<__nv_bfloat16>(
            static_cast<const __nv_bfloat16*>(tab.g[t]), lo, hi, has_inv, iv,
            acc, bad);
        break;
    }
  }
  const int any_bad = __syncthreads_or(bad);
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    part_sum[b] = s;
    part_bad[b] = any_bad;
    __threadfence();
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The last CTA: warp w adds the partials of tensors w, w + 8, ... in a
  // fixed order (lanes stride over the chunks, then a fixed butterfly).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < tab.count; t += kThreads / 32) {
    float v = 0.f;
    for (int c = tab.start[t] + lane; c < tab.start[t + 1]; c += 32)
      v = __fadd_rn(v, __ldcg(part_sum + c));
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) sumsq[t] = v;
  }
  int bad_all = 0;
  for (int c = threadIdx.x; c < static_cast<int>(gridDim.x); c += kThreads)
    bad_all |= __ldcg(part_bad + c);
  bad_all = __syncthreads_or(bad_all);  // also orders the sumsq writes
  if (threadIdx.x == 0) {
    float tot = first ? 0.f : *total;
    for (int t = 0; t < tab.count; ++t) tot = __fadd_rn(tot, sumsq[t]);
    *total = tot;
    *finite = (first ? 1 : *finite) && !bad_all;
  }
}

// ---------------------------------------------------------------------------
// U2: Adam / AdamW
// ---------------------------------------------------------------------------

struct AdamTable {
  void* p[kAdamMax];
  const void* g[kAdamMax];
  void* m[kAdamMax];
  void* v[kAdamMax];
  long long n[kAdamMax];
  int start[kAdamMax + 1];
  int count;
};

// The rule's constants, each already rounded to the parameters' dtype (the
// wrapper computes them as the plain rule does: adam_scalars), and the
// betas in fp32 for the bias corrections.
struct AdamScalars {
  float b1_32, b2_32, b1, omb1, b2, omb2, eps, wd;
  int decoupled;
};

// The step's learning rate and bias corrections, each rounded to T.
struct AdamStep {
  float lr, bc1, bc2;
};

// One element, in the plain rule's op order, each op rounded to T.
template <typename T>
__device__ __forceinline__ void adam_elem(T& pe, T ge, T& me, T& ve,
                                          const AdamScalars& s,
                                          const AdamStep& k, bool has_inv,
                                          float inv, bool has_clip,
                                          float clip) {
  float g = Num<T>::to(ge);
  if (has_inv) g = rnd<T>(__fmul_rn(g, inv));
  if (has_clip) g = rnd<T>(__fmul_rn(g, clip));
  const float p = Num<T>::to(pe);
  const bool decay = s.wd != 0.f;
  if (decay && !s.decoupled)
    g = rnd<T>(__fadd_rn(g, rnd<T>(__fmul_rn(s.wd, p))));
  const float m = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(s.b1, Num<T>::to(me))),
                                   rnd<T>(__fmul_rn(s.omb1, g))));
  const float v = rnd<T>(
      __fadd_rn(rnd<T>(__fmul_rn(s.b2, Num<T>::to(ve))),
                rnd<T>(__fmul_rn(s.omb2, rnd<T>(__fmul_rn(g, g))))));
  const float den = rnd<T>(
      __fadd_rn(rnd<T>(__fsqrt_rn(rnd<T>(__fdiv_rn(v, k.bc2)))), s.eps));
  float upd = rnd<T>(__fdiv_rn(rnd<T>(__fdiv_rn(m, k.bc1)), den));
  if (decay && s.decoupled)
    upd = rnd<T>(__fadd_rn(upd, rnd<T>(__fmul_rn(s.wd, p))));
  pe = Num<T>::from(__fsub_rn(p, rnd<T>(__fmul_rn(k.lr, upd))));
  me = Num<T>::from(m);
  ve = Num<T>::from(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adam_kernel(
    const __grid_constant__ AdamTable tab, const AdamScalars s,
    const float* __restrict__ lr_ptr, const int* __restrict__ step_ptr,
    const float* __restrict__ inv_ptr, const float* __restrict__ clip_ptr,
    const int* __restrict__ finite) {
  if (finite != nullptr && *finite == 0) return;  // a skipped step
  // the JAX rule: t = step as float32, (1 - beta ** t) in float32, then
  // rounded to the dtype; lr.astype(dtype)
  const float steps = __int2float_rn(*step_ptr);
  const AdamStep k{rnd<T>(*lr_ptr),
                   rnd<T>(__fsub_rn(1.f, powf(s.b1_32, steps))),
                   rnd<T>(__fsub_rn(1.f, powf(s.b2_32, steps)))};
  const int b = blockIdx.x;
  const int t = find_tensor(tab.start, tab.count, b);
  const long long lo = static_cast<long long>(b - tab.start[t]) * kChunk;
  const long long hi = min(lo + kChunk, tab.n[t]);
  T* __restrict__ p = static_cast<T*>(tab.p[t]);
  const T* __restrict__ g = static_cast<const T*>(tab.g[t]);
  T* __restrict__ m = static_cast<T*>(tab.m[t]);
  T* __restrict__ v = static_cast<T*>(tab.v[t]);
  const bool has_inv = inv_ptr != nullptr, has_clip = clip_ptr != nullptr;
  const float inv = has_inv ? rnd<T>(*inv_ptr) : 1.f;
  const float clip = has_clip ? rnd<T>(*clip_ptr) : 1.f;
  constexpr int VEC = 16 / sizeof(T);
  long long i = lo;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v);
  if (bits % 16 == 0) {
    const long long vend = lo + (hi - lo) / VEC * VEC;
    for (long long j = lo + threadIdx.x * VEC; j < vend;
         j += kThreads * VEC) {
      uint4 rp = __ldcs(reinterpret_cast<const uint4*>(p + j));
      uint4 rg = __ldcs(reinterpret_cast<const uint4*>(g + j));
      uint4 rm = __ldcs(reinterpret_cast<const uint4*>(m + j));
      uint4 rv = __ldcs(reinterpret_cast<const uint4*>(v + j));
      T* ep = reinterpret_cast<T*>(&rp);
      const T* eg = reinterpret_cast<const T*>(&rg);
      T* em = reinterpret_cast<T*>(&rm);
      T* ev = reinterpret_cast<T*>(&rv);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        adam_elem<T>(ep[e], eg[e], em[e], ev[e], s, k, has_inv, inv,
                     has_clip, clip);
      __stcs(reinterpret_cast<uint4*>(p + j), rp);
      __stcs(reinterpret_cast<uint4*>(m + j), rm);
      __stcs(reinterpret_cast<uint4*>(v + j), rv);
    }
    i = vend;
  }
  for (long long j = i + threadIdx.x; j < hi; j += kThreads) {
    T pe = p[j], me = m[j], ve = v[j];
    adam_elem<T>(pe, g[j], me, ve, s, k, has_inv, inv, has_clip, clip);
    p[j] = pe;
    m[j] = me;
    v[j] = ve;
  }
}

// Chunks of n elements, or -1 past INT_MAX in all.
long long plan_chunks(const long long* n, int count, int* start) {
  long long chunks = 0;
  start[0] = 0;
  for (int t = 0; t < count; ++t) {
    if (n[t] < 0) return -1;
    chunks += (n[t] + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return -1;
    start[t + 1] = static_cast<int>(chunks);
  }
  return chunks;
}

long long sumsq_workspace_bytes(long long chunks) {
  const long long grid = chunks > 0 ? chunks : 1;
  return 16 + 8 * grid;  // counter (padded), grid floats, grid ints
}

}  // namespace

extern "C" {

// Bytes of scratch U1 needs for these tensor sizes (the wrapper allocates
// it), or -1 for sizes it cannot take.
long long pt_multi_tensor_sumsq_workspace(const long long* n, int count) {
  if (count < 0 || count > kSumsqMax) return -1;
  int start[kSumsqMax + 1];
  const long long chunks = plan_chunks(n, count, start);
  return chunks < 0 ? -1 : sumsq_workspace_bytes(chunks);
}

int pt_multi_tensor_sumsq_finite(const void* const* g, const long long* n,
                                 const int* dtype, int count,
                                 const float* inv, float* sumsq, float* total,
                                 int* finite, int first, void* workspace,
                                 long long workspace_bytes, void* stream) {
  if (count < 0 || count > kSumsqMax) return cudaErrorInvalidValue;
  SumsqTable tab;
  tab.count = count;
  const long long chunks = plan_chunks(n, count, tab.start);
  if (chunks < 0) return cudaErrorInvalidValue;
  for (int t = 0; t < count; ++t) {
    if (dtype[t] != kF32 && dtype[t] != kF16 && dtype[t] != kBF16)
      return cudaErrorInvalidValue;
    tab.g[t] = g[t];
    tab.n[t] = n[t];
    tab.dtype[t] = static_cast<unsigned char>(dtype[t]);
  }
  if (workspace_bytes < sumsq_workspace_bytes(chunks))
    return cudaErrorInvalidValue;
  const int grid = chunks > 0 ? static_cast<int>(chunks) : 1;
  auto* counter = static_cast<unsigned int*>(workspace);
  auto* part_sum = reinterpret_cast<float*>(static_cast<char*>(workspace) +
                                            16);
  auto* part_bad = reinterpret_cast<int*>(part_sum + grid);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return err;
  sumsq_finite_kernel<<<grid, kThreads, 0, st>>>(
      tab, inv, part_sum, part_bad, counter, sumsq, total, finite, first);
  return cudaGetLastError();
}

// Returns 0 with nothing launched when every tensor is empty.
// lr: a 0-dim fp32 device tensor; step: a 0-dim int32 device tensor.
int pt_multi_tensor_adam(void* const* p, const void* const* g, void* const* m,
                         void* const* v, const long long* n, int count,
                         int dtype, float b1_32, float b2_32, float b1,
                         float omb1, float b2, float omb2, float eps,
                         float wd, int decoupled, const float* lr,
                         const int* step, const float* inv, const float* clip,
                         const int* finite, void* stream) {
  if (lr == nullptr || step == nullptr) return cudaErrorInvalidValue;
  if (count < 0 || count > kAdamMax) return cudaErrorInvalidValue;
  AdamTable tab;
  tab.count = count;
  const long long chunks = plan_chunks(n, count, tab.start);
  if (chunks < 0) return cudaErrorInvalidValue;
  if (chunks == 0) return cudaSuccess;
  for (int t = 0; t < count; ++t) {
    tab.p[t] = p[t];
    tab.g[t] = g[t];
    tab.m[t] = m[t];
    tab.v[t] = v[t];
    tab.n[t] = n[t];
  }
  const AdamScalars s{b1_32, b2_32, b1, omb1, b2, omb2, eps, wd, decoupled};
  const int grid = static_cast<int>(chunks);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      adam_kernel<float><<<grid, kThreads, 0, st>>>(tab, s, lr, step, inv,
                                                    clip, finite);
      break;
    case kF16:
      adam_kernel<__half><<<grid, kThreads, 0, st>>>(tab, s, lr, step, inv,
                                                     clip, finite);
      break;
    case kBF16:
      adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(tab, s, lr, step,
                                                            inv, clip,
                                                            finite);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
