// Mamba's depthwise causal conv with its bias and SiLU, forward and backward, for NVIDIA Hopper (sm_90a):
// mamba_ssm's causal-conv1d arithmetic, f32 in registers and one rounding to the compute dtype.
//
// Replaces no TPU kernel: the JAX package's conv (multimodal_llm_pretraining_tpu/ops/selective_scan.py,
// causal_conv1d) is XLA's conv_general_dilated, fused with the SiLU into the passes around it. Under
// PyTorch's eager autograd the published f32 arithmetic made seven passes forward over a [B, L, I] tensor
// (a cast of the strided half of in_proj's output to f32, a transposing pad, PyTorch's depthwise conv, the
// SiLU in f32, a cast back that left a channel-first layout, and two copies to contiguous behind it) and
// more backward. These two kernels make one pass each (ops/causal_conv.py).
//
//   causal_conv_fwd_kernel: for x [B, L, I] (bf16 or f32; rows of the caller's stride, channels
//     contiguous), taps w [K, I] and bias [I] (bf16 or f32, widened in registers),
//     pre[b, t, i] = bias[i] + sum_k w[k, i] * x[b, t + k - (K - 1), i]   (x = 0 before t = 0),
//     out[b, t, i] = SiLU(pre) = pre / (1 + exp(-pre)),
//     in f32, rounded once to x's dtype, out contiguous [B, L, I].
//   causal_conv_bwd_kernel: from x and dout (x's dtype, contiguous), with pre recomputed and
//     g = dout * SiLU'(pre) = dout * s * (1 + pre * (1 - s)), s = sigmoid(pre), in f32,
//     dx[b, t, i] = sum_k w[k, i] * g[b, t + (K - 1) - k, i]   (g = 0 from t = L), rounded once to x's dtype;
//     dw[k, i] = sum_{b, t} g[b, t, i] * x[b, t + k - (K - 1), i],  db[i] = sum_{b, t} g[b, t, i],
//     each block's f32 partial sums written to a row of its own, [partials, K + 1, I] (dw's K rows, then
//     db's); the caller sums the partials once, in a fixed order, so two runs repeat bit for bit.
//
// Bound: bytes. At mamba-2.8b's micro-batch of 8 x 4096 rows of d_inner 5120 in bf16 the forward reads x
// (335 MB) and writes out (335 MB): 0.200 ms at 3.35 TB/s. The backward reads x and dout and writes dx:
// 1.0 GB, 0.300 ms. Their operations, about 10 a byte, are far below the card's rates.
// Design: channel-last. A thread owns 4 consecutive channels (an 8-byte bf16 load a row), so the 32 threads
// of a warp read 256 neighbouring bytes of a row; threads in y own consecutive slices of time within the
// block (the forward 64 steps, the backward 128). A thread keeps its channels' taps and bias and the last
// K - 1 inputs (the backward also the last K - 1 g) in f32 registers and walks its slice in groups of 4
// rows, the next group's loads issued before this group computes, so loads stay in flight while it
// computes. It re-reads only the K - 1 rows before its slice (the backward also the K - 1 after it, whose
// g it recomputes), rows its neighbour in y loads too, so they come from L2. The backward sums dw and db
// over its block's slices through shared memory, in slice order. Grid: (channel tiles, time tiles, batch);
// at the shape above 40 x 16 x 8 blocks of 128 threads forward, 40 x 4 x 8 of 256 backward. Tile sizes
// and group depths were chosen by timing variants at that shape on an H100 (the forward at 8 channels a
// thread, without the early loads, ran at 66% of its bound, this design at 80%; the backward at 32-step
// slices without them at 51%, this design at 66%).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int MAX_K = 4;
constexpr int FWD_C = 4;        // channels a thread
constexpr int FWD_GROUPS = 32;  // threads in x: channel groups a block
constexpr int FWD_SLICES = 4;   // threads in y: time slices a block
constexpr int FWD_STEPS = 64;   // steps a slice
constexpr int FWD_U = 4;        // bf16 rows a load group (f32: half as many, the same bytes)
constexpr int BWD_C = 4;
constexpr int BWD_GROUPS = 32;
constexpr int BWD_SLICES = 8;
constexpr int BWD_STEPS = 128;
constexpr int BWD_U = 4;
constexpr int FWD_TILE_T = FWD_SLICES * FWD_STEPS;  // 256 steps a block
constexpr int BWD_TILE_T = BWD_SLICES * BWD_STEPS;  // 1024 steps a block
constexpr int MAX_GRID_YZ = 65535;

__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow1(float v);
template <>
__device__ __forceinline__ float narrow1<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow1<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// C elements of T as raw 32-bit words: what one thread loads of a row.
template <typename T, int C>
struct Row {
  static constexpr int WORDS = C * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[WORDS];
};

// Loads the C elements at p: with VEC in 16- or 8-byte pieces (p aligned to them, all C in range), else
// one by one, those at or past `valid` as 0. A row outside the sequence (`in` false) is 0, unread.
template <typename T, int C, bool VEC>
__device__ __forceinline__ Row<T, C> load_row(const T* p, int valid, bool in) {
  Row<T, C> r;
  constexpr int W = Row<T, C>::WORDS;
  if (!in) {
#pragma unroll
    for (int i = 0; i < W; ++i) r.w[i] = 0u;
    return r;
  }
  if constexpr (VEC) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        r.w[4 * i] = u.x, r.w[4 * i + 1] = u.y, r.w[4 * i + 2] = u.z, r.w[4 * i + 3] = u.w;
      }
    } else {
      static_assert(W == 2, "a thread's row is 8, 16 or 32 bytes");
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      r.w[0] = u.x, r.w[1] = u.y;
    }
  } else {
    T e[C];
#pragma unroll
    for (int j = 0; j < C; ++j) e[j] = j < valid ? p[j] : narrow1<T>(0.f);
    memcpy(r.w, e, sizeof(e));
  }
  return r;
}

template <int C>
__device__ __forceinline__ void widen(const Row<float, C>& r, float (&v)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = __uint_as_float(r.w[j]);
}

template <int C>
__device__ __forceinline__ void widen(const Row<__nv_bfloat16, C>& r, float (&v)[C]) {
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &r.w[i], 4);
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// Stores v rounded to T at p, as load_row reads it.
template <typename T, int C, bool VEC>
__device__ __forceinline__ void store_row(T* p, const float (&v)[C], int valid) {
  T e[C];
#pragma unroll
  for (int j = 0; j < C; ++j) e[j] = narrow1<T>(v[j]);
  if constexpr (VEC) {
    Row<T, C> r;
    constexpr int W = Row<T, C>::WORDS;
    memcpy(r.w, e, sizeof(e));
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i)
        reinterpret_cast<uint4*>(p)[i] = make_uint4(r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (j < valid) p[j] = e[j];
  }
}

// The taps [K, C] and bias [C] of channels c0.. (those at or past `valid` 0), widened to f32.
template <typename TW, int K, int C>
__device__ __forceinline__ void load_taps(const TW* __restrict__ w, const TW* __restrict__ bias, int c0, int I,
                                          int valid, float (&wk)[K][C], float (&bv)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    bv[j] = j < valid ? widen1(bias[c0 + j]) : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k][j] = j < valid ? widen1(w[static_cast<int64_t>(k) * I + c0 + j]) : 0.f;
  }
}

// pre = bias + sum_k w[k] * x[t + k - (K - 1)]: hist holds x[t - (K - 1) .. t - 1], oldest first.
template <int K, int C>
__device__ __forceinline__ void pre_act(const float (&wk)[K][C], const float (&bv)[C], const float (&hist)[MAX_K][C],
                                        const float (&cur)[C], float (&pre)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float acc = bv[j];
#pragma unroll
    for (int k = 0; k < K - 1; ++k) acc = fmaf(wk[k][j], hist[k][j], acc);
    pre[j] = fmaf(wk[K - 1][j], cur[j], acc);
  }
}

__device__ __forceinline__ float sigmoid(float p) { return __frcp_rn(1.f + __expf(-p)); }

template <int K, int C>
__device__ __forceinline__ void push(float (&hist)[MAX_K][C], const float (&cur)[C]) {
#pragma unroll
  for (int k = 0; k + 1 < K - 1; ++k)
#pragma unroll
    for (int j = 0; j < C; ++j) hist[k][j] = hist[k + 1][j];
  if constexpr (K > 1) {
#pragma unroll
    for (int j = 0; j < C; ++j) hist[K - 2][j] = cur[j];
  }
}

template <typename TX, typename TW, int K, bool VEC>
__global__ void __launch_bounds__(FWD_GROUPS * FWD_SLICES)
    causal_conv_fwd_kernel(const TX* __restrict__ x, int64_t x_batch_stride, int64_t x_row_stride,
                           const TW* __restrict__ w, const TW* __restrict__ bias, TX* __restrict__ out, int L, int I) {
  constexpr int C = FWD_C;
  const int c0 = (blockIdx.x * FWD_GROUPS + threadIdx.x) * C;
  const int t0 = blockIdx.y * FWD_TILE_T + threadIdx.y * FWD_STEPS;
  if (c0 >= I || t0 >= L) return;
  const int valid = min(C, I - c0);
  const int t1 = min(t0 + FWD_STEPS, L);
  const TX* xb = x + blockIdx.z * x_batch_stride + c0;
  TX* ob = out + static_cast<int64_t>(blockIdx.z) * L * I + c0;

  float wk[K][C], bv[C];
  load_taps<TW, K, C>(w, bias, c0, I, valid, wk, bv);
  float hist[MAX_K][C];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const int t = t0 - (K - 1) + k;
    widen(load_row<TX, C, VEC>(xb + t * x_row_stride, valid, t >= 0), hist[k]);
  }
  constexpr int U = FWD_U * 2 / static_cast<int>(sizeof(TX));
  auto load_rows = [&](int base, Row<TX, C>(&dst)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) dst[u] = load_row<TX, C, VEC>(xb + (base + u) * x_row_stride, valid, base + u < t1);
  };
  Row<TX, C> ahead[U];  // the next group's rows, in flight while this group computes
  load_rows(t0, ahead);
  for (int base = t0; base < t1; base += U) {
    Row<TX, C> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) raw[u] = ahead[u];
    load_rows(base + U, ahead);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float cur[C], v[C];
      widen(raw[u], cur);
      pre_act<K, C>(wk, bv, hist, cur, v);
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] *= sigmoid(v[j]);
      push<K, C>(hist, cur);
      if (base + u < t1) store_row<TX, C, VEC>(ob + static_cast<int64_t>(base + u) * I, v, valid);
    }
  }
}

template <typename TX, typename TW, int K, bool VEC>
__global__ void __launch_bounds__(BWD_GROUPS * BWD_SLICES, 2)
    causal_conv_bwd_kernel(const TX* __restrict__ x, int64_t x_batch_stride, int64_t x_row_stride,
                           const TW* __restrict__ w, const TW* __restrict__ bias, const TX* __restrict__ dout,
                           TX* __restrict__ dx, float* __restrict__ part, int L, int I) {
  constexpr int C = BWD_C;
  constexpr int TILE_C = BWD_GROUPS * C;
  __shared__ float red[BWD_SLICES][K + 1][TILE_C];
  const int c0 = (blockIdx.x * BWD_GROUPS + threadIdx.x) * C;
  const int t0 = blockIdx.y * BWD_TILE_T + threadIdx.y * BWD_STEPS;
  float dw[K][C], db[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    db[j] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dw[k][j] = 0.f;
  }
  if (c0 < I && t0 < L) {
    const int valid = min(C, I - c0);
    const int t1 = min(t0 + BWD_STEPS, L);
    const int s_end = t1 + K - 1;  // g of steps t1 .. t1 + K - 2 reaches dx of the slice's last steps
    const TX* xb = x + blockIdx.z * x_batch_stride + c0;
    const int64_t row0 = static_cast<int64_t>(blockIdx.z) * L * I + c0;
    const TX* gb = dout + row0;
    TX* dxb = dx + row0;

    float wk[K][C], bv[C];
    load_taps<TW, K, C>(w, bias, c0, I, valid, wk, bv);
    float xh[MAX_K][C], gh[MAX_K][C];  // x and g of the K - 1 steps before s, oldest first
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      const int t = t0 - (K - 1) + k;
      widen(load_row<TX, C, VEC>(xb + t * x_row_stride, valid, t >= 0), xh[k]);
#pragma unroll
      for (int j = 0; j < C; ++j) gh[k][j] = 0.f;  // steps before the slice add nothing to its dx
    }
    auto load_rows = [&](int base, Row<TX, C>(&dx_)[BWD_U], Row<TX, C>(&dg)[BWD_U]) {
#pragma unroll
      for (int u = 0; u < BWD_U; ++u) {
        const int s = base + u;
        dx_[u] = load_row<TX, C, VEC>(xb + s * x_row_stride, valid, s < L && s < s_end);
        dg[u] = load_row<TX, C, VEC>(gb + static_cast<int64_t>(s) * I, valid, s < L && s < s_end);
      }
    };
    Row<TX, C> ax[BWD_U], ag[BWD_U];  // the next group's rows, in flight while this group computes
    load_rows(t0, ax, ag);
    for (int base = t0; base < s_end; base += BWD_U) {
      Row<TX, C> rx[BWD_U], rg[BWD_U];
#pragma unroll
      for (int u = 0; u < BWD_U; ++u) rx[u] = ax[u], rg[u] = ag[u];
      load_rows(base + BWD_U, ax, ag);
#pragma unroll
      for (int u = 0; u < BWD_U; ++u) {
        const int s = base + u;
        float cur[C], g[C];
        widen(rx[u], cur);
        widen(rg[u], g);
        float pre[C];
        pre_act<K, C>(wk, bv, xh, cur, pre);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float sg = sigmoid(pre[j]);
          g[j] = s < L ? g[j] * (sg * fmaf(pre[j], 1.f - sg, 1.f)) : 0.f;
        }
        if (s < t1) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            db[j] += g[j];
#pragma unroll
            for (int k = 0; k < K - 1; ++k) dw[k][j] = fmaf(g[j], xh[k][j], dw[k][j]);
            dw[K - 1][j] = fmaf(g[j], cur[j], dw[K - 1][j]);
          }
        }
        const int t = s - (K - 1);
        if (t >= t0 && s < s_end) {
          float d[C];
#pragma unroll
          for (int j = 0; j < C; ++j) {
            float acc = wk[0][j] * g[j];  // dx[t] = sum_k w[k] * g[t + (K - 1) - k]; g[s - k] = gh[K - 1 - k]
#pragma unroll
            for (int k = 1; k < K; ++k) acc = fmaf(wk[k][j], gh[K - 1 - k][j], acc);
            d[j] = acc;
          }
          store_row<TX, C, VEC>(dxb + static_cast<int64_t>(t) * I, d, valid);
        }
        push<K, C>(xh, cur);
        push<K, C>(gh, g);
      }
    }
  }
  // the block's partial sums over its slices, in slice order
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[threadIdx.y][k][threadIdx.x * C + j] = dw[k][j];
    red[threadIdx.y][K][threadIdx.x * C + j] = db[j];
  }
  __syncthreads();
  const int tid = threadIdx.y * BWD_GROUPS + threadIdx.x;
  float* pb = part + (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * (K + 1) * I;
  for (int idx = tid; idx < (K + 1) * TILE_C; idx += BWD_GROUPS * BWD_SLICES) {
    const int k = idx / TILE_C, cc = idx % TILE_C, c = blockIdx.x * TILE_C + cc;
    if (c < I) {
      float sum = 0.f;
#pragma unroll
      for (int y = 0; y < BWD_SLICES; ++y) sum += red[y][k][cc];
      pb[static_cast<int64_t>(k) * I + c] = sum;
    }
  }
}

// Calls Launch<TX, TW, K, VEC>::run(args...) for the dtype codes (0 bf16, 1 f32), K and VEC; false where
// there is no such instantiation.
template <template <typename, typename, int, bool> class Launch, typename... Args>
bool dispatch(int x_dtype, int w_dtype, int k, bool vec, Args... args) {
  auto by_k = [&](auto tx, auto tw, auto v) -> bool {
    using TX = decltype(tx);
    using TW = decltype(tw);
    constexpr bool VEC = decltype(v)::value;
    switch (k) {
      case 1: Launch<TX, TW, 1, VEC>::run(args...); return true;
      case 2: Launch<TX, TW, 2, VEC>::run(args...); return true;
      case 3: Launch<TX, TW, 3, VEC>::run(args...); return true;
      case 4: Launch<TX, TW, 4, VEC>::run(args...); return true;
      default: return false;
    }
  };
  auto by_vec = [&](auto tx, auto tw) -> bool {
    return vec ? by_k(tx, tw, std::true_type{}) : by_k(tx, tw, std::false_type{});
  };
  const __nv_bfloat16 b{};
  const float f = 0.f;
  if (x_dtype == 0 && w_dtype == 0) return by_vec(b, b);
  if (x_dtype == 0 && w_dtype == 1) return by_vec(b, f);
  if (x_dtype == 1 && w_dtype == 0) return by_vec(f, b);
  if (x_dtype == 1 && w_dtype == 1) return by_vec(f, f);
  return false;
}

template <typename TX, typename TW, int K, bool VEC>
struct LaunchFwd {
  static void run(const void* x, long long sb, long long sl, const void* w, const void* bias, void* out, int B, int L,
                  int I, cudaStream_t s) {
    const dim3 grid((I + FWD_GROUPS * FWD_C - 1) / (FWD_GROUPS * FWD_C), (L + FWD_TILE_T - 1) / FWD_TILE_T, B);
    causal_conv_fwd_kernel<TX, TW, K, VEC><<<grid, dim3(FWD_GROUPS, FWD_SLICES), 0, s>>>(
        static_cast<const TX*>(x), sb, sl, static_cast<const TW*>(w), static_cast<const TW*>(bias),
        static_cast<TX*>(out), L, I);
  }
};

template <typename TX, typename TW, int K, bool VEC>
struct LaunchBwd {
  static void run(const void* x, long long sb, long long sl, const void* w, const void* bias, const void* dout,
                  void* dx, float* part, int B, int L, int I, cudaStream_t s) {
    const dim3 grid((I + BWD_GROUPS * BWD_C - 1) / (BWD_GROUPS * BWD_C), (L + BWD_TILE_T - 1) / BWD_TILE_T, B);
    causal_conv_bwd_kernel<TX, TW, K, VEC><<<grid, dim3(BWD_GROUPS, BWD_SLICES), 0, s>>>(
        static_cast<const TX*>(x), sb, sl, static_cast<const TW*>(w), static_cast<const TW*>(bias),
        static_cast<const TX*>(dout), static_cast<TX*>(dx), part, L, I);
  }
};

bool takes(int B, int L, int I, int k) {
  return B > 0 && B <= MAX_GRID_YZ && L > 0 && I > 0 && k >= 1 && k <= MAX_K &&
         (L + FWD_TILE_T - 1) / FWD_TILE_T <= MAX_GRID_YZ;
}

}  // namespace

extern "C" {

// Rows of f32 partials the backward writes for a batch of B sequences of L steps: one a block, B x its
// time tiles; each row holds K + 1 rows of I (dw's K, then db).
int mlpt_causal_conv_bwd_partials(int B, int L) { return B * ((L + BWD_TILE_T - 1) / BWD_TILE_T); }

// `vec`: x's base 16-byte aligned, I and both strides multiples of 8, so each thread's row is whole pieces.
int mlpt_causal_conv_fwd(const void* x, long long x_batch_stride, long long x_row_stride, const void* w,
                         const void* bias, void* out, int B, int L, int I, int k, int x_dtype, int w_dtype, int vec,
                         void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  if (!takes(B, L, I, k)) return (int)cudaErrorInvalidValue;
  if (!dispatch<LaunchFwd>(x_dtype, w_dtype, k, vec != 0, x, x_batch_stride, x_row_stride, w, bias, out, B, L, I,
                           static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int mlpt_causal_conv_bwd(const void* x, long long x_batch_stride, long long x_row_stride, const void* w,
                         const void* bias, const void* dout, void* dx, float* part, int B, int L, int I, int k,
                         int x_dtype, int w_dtype, int vec, void* stream) {
  (void)cudaGetLastError();
  if (!takes(B, L, I, k)) return (int)cudaErrorInvalidValue;
  if (!dispatch<LaunchBwd>(x_dtype, w_dtype, k, vec != 0, x, x_batch_stride, x_row_stride, w, bias, dout, dx, part, B,
                           L, I, static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
