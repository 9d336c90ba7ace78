// RMSNorm's forward and backward for NVIDIA Hopper (sm_90a): the published `fused_add_norm` of
// state-spaces/mamba, for a residual stream carried in f32 (or in the compute dtype).
//
// Replaces no TPU kernel: the JAX package's RMSNorm is flax's nn.RMSNorm, which XLA fuses into the passes
// around it. Under PyTorch's eager autograd the same arithmetic over an f32 stream made about five passes
// forward (the cast, the square, the mean, the scale, the product and the cast back) and more backward,
// and autograd summed the residual's gradient into the norm's in one more pass. These two kernels make one
// pass each (ops/rmsnorm.py).
//
//   rmsnorm_fwd_kernel: per row r of x [rows, cols] (f32 or bf16),
//     rstd[r] = 1 / sqrt(mean_c x[r, c]^2 + eps)  (the mean square in f32),
//     y[r, c] = x[r, c] * (rstd[r] * w[c])        (in f32, rounded once to y's dtype).
//   rmsnorm_bwd_kernel: with g = dy * w,
//     dx[r, c] = g[r, c] * rstd[r] - x[r, c] * rstd[r]^3 * mean_c (g[r, c] * x[r, c]) (+ dres[r, c]),
//     in f32 and rounded once to x's dtype; dres is the gradient the residual stream brings past the norm
//     (the block's `x + out` add), so the stream's gradient is written once. The scale's gradient
//     dw[c] = sum_r dy[r, c] * x[r, c] * rstd[r] is summed by each block over the rows it takes into a
//     partial row of its own, [grid, cols] f32; the caller sums the partials once, in a fixed order
//     (and passes no partials where the scale is frozen).
//
// Bound: bytes. At mamba-2.8b's micro-batch of 8 x 4096 rows of 2560, the forward reads the f32 stream
// (336 MB) and writes bf16 (168 MB) and rstd: 0.150 ms at 3.35 TB/s. The backward reads bf16 dy, the f32
// stream and the f32 residual gradient and writes the f32 stream gradient: 1.17 GB, 0.350 ms.
// Design: a row's four-element groups are spread over the threads of a block, K groups a thread
// (K = 1, 2, 4 or 8, the least that keeps a block at 256 threads or fewer; at 2560 columns K = 4 and 160
// threads), so a row is loaded into registers once and written once, with 16-byte f32 loads and 8-byte
// bf16 loads. The sum of squares (and the backward's dot) goes over the warps by shuffles, then through
// shared memory. The forward takes one row a block; the backward keeps one block resident for each slot
// the card holds and walks the rows with a stride of the grid, so that each thread's share of dw stays in
// registers across its rows; the scale's K groups are loaded once a block. Every sum runs in a fixed
// order, so a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_COLS = 8 * 4 * MAX_THREADS;  // K = 8 groups of four a thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) { return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w); }

// The sum of v over the block, in every thread; `part` holds one value a warp. blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = lane < warps ? part[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // `part` is written again for the next row
  return v;
}

template <typename TX, typename TY, int K>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                                                                  TY* __restrict__ y, float* __restrict__ rstd,
                                                                  int cols, float eps) {
  __shared__ float part[32];
  const int n4 = cols / 4;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * cols;
  float4 v[K];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    v[k] = i < n4 ? load4(x + base + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
    ss += dot4(v[k], v[k]);
  }
  ss = block_sum(ss, part);
  const float r = rsqrtf(ss / static_cast<float>(cols) + eps);
  if (threadIdx.x == 0) rstd[blockIdx.x] = r;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n4) {
      const float4 s = load4(w + 4 * i);
      store4(y + base + 4 * i, make_float4(v[k].x * (r * s.x), v[k].y * (r * s.y), v[k].z * (r * s.z),
                                           v[k].w * (r * s.w)));
    }
  }
}

template <typename TX, typename TG, int K>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_bwd_kernel(const TG* __restrict__ dy, const TX* __restrict__ x,
                                                                  const float* __restrict__ rstd,
                                                                  const float* __restrict__ w,
                                                                  const TX* __restrict__ dres, TX* __restrict__ dx,
                                                                  float* __restrict__ dw_part, int rows, int cols) {
  __shared__ float part[32];
  const int n4 = cols / 4;
  const float inv_cols = 1.f / static_cast<float>(cols);
  float4 wv[K], acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    wv[k] = i < n4 ? load4(w + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t base = static_cast<int64_t>(row) * cols;
    const float r = rstd[row];
    float4 xv[K], gv[K], rv[K];
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      xv[k] = i < n4 ? load4(x + base + 4 * i) : zero;
      const float4 d = i < n4 ? load4(dy + base + 4 * i) : zero;
      rv[k] = (dres != nullptr && i < n4) ? load4(dres + base + 4 * i) : zero;
      acc[k].x += d.x * (xv[k].x * r);
      acc[k].y += d.y * (xv[k].y * r);
      acc[k].z += d.z * (xv[k].z * r);
      acc[k].w += d.w * (xv[k].w * r);
      gv[k] = make_float4(d.x * wv[k].x, d.y * wv[k].y, d.z * wv[k].z, d.w * wv[k].w);
      dot += dot4(gv[k], xv[k]);
    }
    dot = block_sum(dot, part);
    const float c = r * r * r * (dot * inv_cols);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n4) {
        store4(dx + base + 4 * i, make_float4((gv[k].x * r - xv[k].x * c) + rv[k].x, (gv[k].y * r - xv[k].y * c) + rv[k].y,
                                              (gv[k].z * r - xv[k].z * c) + rv[k].z, (gv[k].w * r - xv[k].w * c) + rv[k].w));
      }
    }
  }
  if (dw_part != nullptr) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n4) store4(dw_part + static_cast<int64_t>(blockIdx.x) * cols + 4 * i, acc[k]);
    }
  }
}

// Groups of four a thread and threads a block for `cols` columns; false where the kernels do not take it.
bool plan(int cols, int* k, int* threads) {
  if (cols <= 0 || cols % 4 != 0 || cols > MAX_COLS) return false;
  const int n4 = cols / 4;
  for (int kk = 1; kk <= 8; kk *= 2) {
    const int t = (n4 + kk - 1) / kk;
    if (t <= MAX_THREADS) {
      *k = kk;
      *threads = (t + 31) / 32 * 32;
      return true;
    }
  }
  return false;
}

// Calls f with the instantiation of the (x, second) dtype codes (0 bf16, 1 f32) and K; false where none is.
template <template <typename, typename, int> class Launch, typename... Args>
bool dispatch(int x_dtype, int second_dtype, int k, Args... args) {
  auto by_k = [&](auto tx, auto t2) -> bool {
    using TX = decltype(tx);
    using T2 = decltype(t2);
    switch (k) {
      case 1: Launch<TX, T2, 1>::run(args...); return true;
      case 2: Launch<TX, T2, 2>::run(args...); return true;
      case 4: Launch<TX, T2, 4>::run(args...); return true;
      case 8: Launch<TX, T2, 8>::run(args...); return true;
      default: return false;
    }
  };
  const __nv_bfloat16 b{};
  const float f = 0.f;
  if (x_dtype == 0 && second_dtype == 0) return by_k(b, b);
  if (x_dtype == 0 && second_dtype == 1) return by_k(b, f);
  if (x_dtype == 1 && second_dtype == 0) return by_k(f, b);
  if (x_dtype == 1 && second_dtype == 1) return by_k(f, f);
  return false;
}

template <typename TX, typename TY, int K>
struct LaunchFwd {
  static void run(const void* x, const float* w, void* y, float* rstd, int rows, int cols, float eps, int threads,
                  cudaStream_t s) {
    rmsnorm_fwd_kernel<TX, TY, K><<<rows, threads, 0, s>>>(static_cast<const TX*>(x), w, static_cast<TY*>(y), rstd,
                                                           cols, eps);
  }
};

template <typename TX, typename TG, int K>
struct LaunchBwd {
  static void run(const void* dy, const void* x, const float* rstd, const float* w, const void* dres, void* dx,
                  float* dw_part, int rows, int cols, int grid, int threads, cudaStream_t s) {
    rmsnorm_bwd_kernel<TX, TG, K><<<grid, threads, 0, s>>>(static_cast<const TG*>(dy), static_cast<const TX*>(x), rstd,
                                                           w, static_cast<const TX*>(dres), static_cast<TX*>(dx),
                                                           dw_part, rows, cols);
  }
};

template <typename TX, typename TG, int K>
struct BwdOccupancy {
  static void run(int threads, int* blocks) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, rmsnorm_bwd_kernel<TX, TG, K>, threads, 0);
  }
};

}  // namespace

extern "C" {

int mlpt_rmsnorm_fwd(const void* x, const float* w, void* y, float* rstd, int rows, int cols, float eps, int x_dtype,
                     int y_dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  int k, threads;
  if (rows <= 0 || !plan(cols, &k, &threads)) return (int)cudaErrorInvalidValue;
  if (!dispatch<LaunchFwd>(x_dtype, y_dtype, k, x, w, y, rstd, rows, cols, eps, threads,
                           static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The backward's grid for `rows` rows of `cols`: every block the card holds at once, at most one a row.
// Returns 0 where the kernels do not take the shape or the dtypes.
int mlpt_rmsnorm_bwd_grid(int rows, int cols, int x_dtype, int dy_dtype) {
  int k, threads, blocks = 0, device, sms;
  if (rows <= 0 || !plan(cols, &k, &threads)) return 0;
  if (!dispatch<BwdOccupancy>(x_dtype, dy_dtype, k, threads, &blocks)) return 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const long long grid = static_cast<long long>(blocks > 0 ? blocks : 1) * sms;
  return static_cast<int>(grid < rows ? grid : rows);
}

int mlpt_rmsnorm_bwd(const void* dy, const void* x, const float* rstd, const float* w, const void* dres, void* dx,
                     float* dw_part, int rows, int cols, int grid, int x_dtype, int dy_dtype, void* stream) {
  (void)cudaGetLastError();
  int k, threads;
  if (rows <= 0 || grid <= 0 || grid > rows || !plan(cols, &k, &threads)) return (int)cudaErrorInvalidValue;
  if (!dispatch<LaunchBwd>(x_dtype, dy_dtype, k, dy, x, rstd, w, dres, dx, dw_part, rows, cols, grid, threads,
                           static_cast<cudaStream_t>(stream)))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
