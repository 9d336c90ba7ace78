// The LM-head cross entropy's two memory-bound steps for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's loss (multimodal_llm_pretraining_tpu/ops/xent.py,
// chunked_lm_cross_entropy) has no Pallas kernel, XLA fusing its logsumexp, gather and their
// gradient into the passes around the head's product. Under PyTorch's eager autograd the same
// arithmetic made some ten passes over each chunk's f32 logits (logsumexp, the gather, and in the
// backward an exp, a sub, a mul, a zero-filled scatter, an add and a cast): 60 of the 107 ms a
// pythia-1b micro-batch spent in its loss on an H100. These two kernels do that work in one pass
// each; the head's products around them stay cuBLAS's (ops/xent.py).
//
//   xent_fwd_kernel: per row r of the f32 logits [rows, stride], columns at or past vocab never read,
//     lse[r] = log sum_{c < vocab} exp(logits[r, c]),   nll[r] = (lse[r] - logits[r, label[r]]) * valid[r];
//     the caller sums nll once over all chunks.
//   xent_bwd_kernel: dlogits[r, c] = (exp(logits[r, c] - lse[r]) - [c == label[r]]) * (*scale) * valid[r]
//     for c < vocab, 0 for vocab <= c < stride; computed in f32 and rounded once to bf16, or kept in f32.
//
// valid[r] is label[r] != ignore_index. An ignored row is not read: the forward writes lse 0 and nll 0
// for it, the backward a row of zeros (llava's image positions, about half its rows, cost nothing). A
// label outside [0, vocab) that is not ignore_index gives nll NaN, so the loss shows it. *scale, the
// loss's gradient over the count of valid rows, is read from device memory: the host never waits.
//
// Bound: bytes. At pythia-1b's chunk of 1024 rows of 50,304 the forward reads 206 MB of logits (0.062
// ms at 3.35 TB/s) and the backward reads them and writes 103 MB of bf16 dlogits (0.092 ms). Their exps,
// 5.2e7 a launch, take 0.012 ms at the special-function units' 16 a clock an SM, so bytes bound both.
// Design: one block of 256 threads a row, 8 blocks an SM, so 1024 rows are one wave on 132 SMs. Each
// thread streams its share of the row in 16-byte loads, four in flight, marked evict-first (each logit
// is read once), and keeps a running max and a sum of exp(x - max) in f32: a larger max rescales the
// sum by one exp, so each logit costs one exp2 of (x - max) * log2(e). The difference comes first, as in
// PyTorch's exp(x - lse): where x is the max, or the backward's x is lse (a gold logit the model is sure of),
// it is exactly 0 and the exp exactly 1, so 1 - p keeps its digits. Warps combine (max, sum)
// pairs by shuffles, the block's 8 warps through shared memory. The backward's 16-byte load of four
// logits gives one 8-byte store of four bf16 (16 bytes in f32). Nothing is staged in shared memory: a
// row is read once and no element is reused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // 16-byte loads in flight a thread
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct MaxSum {
  float m;  // the largest logit seen
  float s;  // sum of exp(x - m) over the logits seen
};

__device__ __forceinline__ MaxSum combine(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f};
  return {m, a.s * exp2f((a.m - m) * LOG2E) + b.s * exp2f((b.m - m) * LOG2E)};
}

__device__ __forceinline__ void add1(MaxSum& a, float x) {
  if (x > a.m) {
    a.s *= exp2f((a.m - x) * LOG2E);
    a.m = x;
  }
  a.s += exp2f((x - a.m) * LOG2E);
}

__device__ __forceinline__ void add4(MaxSum& a, float4 v) {
  const float mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  if (mx > a.m) {
    a.s *= exp2f((a.m - mx) * LOG2E);
    a.m = mx;
  }
  a.s += (exp2f((v.x - a.m) * LOG2E) + exp2f((v.y - a.m) * LOG2E)) +
         (exp2f((v.z - a.m) * LOG2E) + exp2f((v.w - a.m) * LOG2E));
}

// (max, sum) over the block, in every thread.
__device__ __forceinline__ MaxSum block_max_sum(MaxSum a) {
  __shared__ MaxSum part[WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = combine(a, {__shfl_xor_sync(FULL, a.m, o), __shfl_xor_sync(FULL, a.s, o)});
  if (lane == 0) part[warp] = a;
  __syncthreads();
  a = lane < WARPS ? part[lane] : MaxSum{-INFINITY, 0.f};
#pragma unroll
  for (int o = WARPS / 2; o > 0; o >>= 1) a = combine(a, {__shfl_xor_sync(FULL, a.m, o), __shfl_xor_sync(FULL, a.s, o)});
  return a;
}

__global__ void __launch_bounds__(THREADS) xent_fwd_kernel(const float* __restrict__ logits,
                                                           const int64_t* __restrict__ labels,
                                                           float* __restrict__ lse, float* __restrict__ nll,
                                                           int vocab, int64_t stride, int64_t ignore_index) {
  const int row = blockIdx.x;
  const int64_t label = labels[row];
  if (label != ignore_index) {
    const float* x = logits + row * stride;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = vocab / 4;
    MaxSum a = {-INFINITY, 0.f};
    int i = threadIdx.x;
    for (; i + (UNROLL - 1) * THREADS < n4; i += UNROLL * THREADS) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x4 + i + u * THREADS);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) add4(a, v[u]);
    }
    for (; i < n4; i += THREADS) add4(a, __ldcs(x4 + i));
    const int c = n4 * 4 + threadIdx.x;  // the last vocab % 4 columns
    if (c < vocab) add1(a, x[c]);
    a = block_max_sum(a);
    if (threadIdx.x == 0) {
      const float l = a.m + logf(a.s);
      lse[row] = l;
      nll[row] = (label >= 0 && label < vocab) ? l - x[label] : __int_as_float(0x7fc00000);  // NaN
    }
  } else if (threadIdx.x == 0) {
    lse[row] = 0.f;
    nll[row] = 0.f;
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

template <typename T>
__global__ void __launch_bounds__(THREADS) xent_bwd_kernel(const float* __restrict__ logits,
                                                           const int64_t* __restrict__ labels,
                                                           const float* __restrict__ lse,
                                                           const float* __restrict__ scale, T* __restrict__ dlogits,
                                                           int vocab, int64_t stride, int64_t ignore_index) {
  const int row = blockIdx.x;
  const int64_t label = labels[row];
  T* d = dlogits + row * stride;
  const int n4 = vocab / 4;
  if (label == ignore_index) {
    for (int i = threadIdx.x; i < n4; i += THREADS) store4(d + 4 * i, 0.f, 0.f, 0.f, 0.f);
    for (int c = n4 * 4 + threadIdx.x; c < stride; c += THREADS) store1(d + c, 0.f);
    return;
  }
  const float* x = logits + row * stride;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float s = *scale, l = lse[row];
  auto grad = [&](float v, int c) { return (exp2f((v - l) * LOG2E) - (c == label ? 1.f : 0.f)) * s; };
  auto put4 = [&](float4 v, int i) {
    const int c = 4 * i;
    store4(d + c, grad(v.x, c), grad(v.y, c + 1), grad(v.z, c + 2), grad(v.w, c + 3));
  };
  int i = threadIdx.x;
  for (; i + (UNROLL - 1) * THREADS < n4; i += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x4 + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) put4(v[u], i + u * THREADS);
  }
  for (; i < n4; i += THREADS) put4(__ldcs(x4 + i), i);
  for (int c = n4 * 4 + threadIdx.x; c < stride; c += THREADS) store1(d + c, c < vocab ? grad(x[c], c) : 0.f);
}

bool shape_ok(int rows, int vocab, long long stride) {
  return rows > 0 && vocab > 0 && stride >= vocab && stride % 4 == 0;
}

}  // namespace

extern "C" {

int mlpt_xent_fwd(const float* logits, const int64_t* labels, float* lse, float* nll, int rows, int vocab,
                  long long stride, long long ignore_index, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  if (!shape_ok(rows, vocab, stride)) return (int)cudaErrorInvalidValue;
  xent_fwd_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(logits, labels, lse, nll, vocab, stride,
                                                                           ignore_index);
  return (int)cudaGetLastError();
}

int mlpt_xent_bwd(const float* logits, const int64_t* labels, const float* lse, const float* scale, void* dlogits,
                  int rows, int vocab, long long stride, long long ignore_index, int dtype, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(rows, vocab, stride)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    xent_bwd_kernel<__nv_bfloat16><<<rows, THREADS, 0, s>>>(logits, labels, lse, scale,
                                                            static_cast<__nv_bfloat16*>(dlogits), vocab, stride,
                                                            ignore_index);
  else if (dtype == 1)
    xent_bwd_kernel<float><<<rows, THREADS, 0, s>>>(logits, labels, lse, scale, static_cast<float*>(dlogits), vocab,
                                                    stride, ignore_index);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
