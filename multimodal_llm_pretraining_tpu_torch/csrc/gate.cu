// Mamba's gate y * SiLU(z), forward and backward, for NVIDIA Hopper (sm_90a): mamba_ssm's arithmetic, f32 in
// registers and one rounding to the compute dtype.
//
// Replaces no TPU kernel: the JAX package's gate (multimodal_llm_pretraining_tpu/models/mamba.py:68) is XLA's,
// fused into the passes around it. Under PyTorch's eager autograd the published f32 arithmetic made four
// passes forward over a [B, L, I] tensor (a cast of the strided half of in_proj's output to f32, the SiLU
// in f32, a mixed-dtype product, a cast back) and about six backward, and saved two f32 tensors for the
// backward. These two kernels make one pass each (ops/gate.py).
//
//   gate_silu_fwd_kernel: for y [rows, I] (the scan's output) and z [rows, I] (bf16 or f32, one dtype;
//     rows of the caller's stride, channels contiguous: z is read where it lies, the second half of
//     in_proj's output),
//     out[r, i] = y * SiLU(z) = y * (z / (1 + exp(-z))),
//     in f32, rounded once to y's dtype, out contiguous [rows, I].
//   gate_silu_bwd_kernel: from dout (contiguous), y and z, with s = 1 / (1 + exp(-z)) in f32,
//     dy = dout * SiLU(z),  dz = (dout * y) * s * (1 + z * (1 - s))   (PyTorch's silu_backward),
//     each rounded once to its input's dtype, both contiguous [rows, I].
//   exp is the accurate expf, not __expf, so that the kernels stay within one rounding of the plain
//   versions.
//
// Bound: bytes. At mamba-2.8b's micro-batch of 8 x 4096 rows of d_inner 5120 in bf16 the forward reads y
// and z and writes out (1.007 GB): 0.300 ms at 3.35 TB/s. The backward reads dout, y and z and writes dy
// and dz (1.678 GB): 0.501 ms. Their operations, a few a byte, are far below the card's rates.
// Design: a thread owns one 16-byte piece of a row (8 bf16 or 4 f32 channels), so the 64 threads of a
// block's row read 1 KB of neighbouring bytes; the block's 4 rows of threads take R rows each (the forward
// 4, the backward 2), and a thread issues all its loads before it computes, so 8 (forward) or 6 (backward)
// 16-byte loads a thread are in flight. Row tiles beyond the grid's 65,535 are walked with a stride of the
// grid. Where I, a row stride or a pointer is not a whole number of pieces, the same kernels load and
// store element by element. No atomics: a second launch repeats the first bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS_X = 64;  // threads in x: 16-byte pieces of a row
constexpr int THREADS_Y = 4;   // threads in y: rows
constexpr int FWD_R = 4;       // rows a thread, forward
constexpr int BWD_R = 2;       // rows a thread, backward
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow1(float v);
template <>
__device__ __forceinline__ float narrow1<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow1<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// One 16-byte piece of a row: C elements of T.
template <typename T>
struct Piece {
  static constexpr int C = 16 / static_cast<int>(sizeof(T));
  uint4 u;
};

// Loads the piece at p: one 16-byte load with VEC (p aligned, all C in range), else element by element,
// those at or past `valid` as 0. A row past the end (`in` false) is 0, unread.
template <typename T, bool VEC>
__device__ __forceinline__ Piece<T> load_piece(const T* p, int valid, bool in) {
  Piece<T> r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  if (!in) return r;
  if constexpr (VEC) {
    r.u = *reinterpret_cast<const uint4*>(p);
  } else {
    T e[Piece<T>::C];
#pragma unroll
    for (int j = 0; j < Piece<T>::C; ++j) e[j] = j < valid ? p[j] : narrow1<T>(0.f);
    memcpy(&r.u, e, sizeof(e));
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void widen(const Piece<T>& r, float (&v)[Piece<T>::C]) {
  T e[Piece<T>::C];
  memcpy(e, &r.u, sizeof(e));
#pragma unroll
  for (int j = 0; j < Piece<T>::C; ++j) v[j] = widen1(e[j]);
}

// Stores v rounded to T at p, as load_piece reads it.
template <typename T, bool VEC>
__device__ __forceinline__ void store_piece(T* p, const float (&v)[Piece<T>::C], int valid) {
  T e[Piece<T>::C];
#pragma unroll
  for (int j = 0; j < Piece<T>::C; ++j) e[j] = narrow1<T>(v[j]);
  if constexpr (VEC) {
    uint4 u;
    memcpy(&u, e, sizeof(e));
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < Piece<T>::C; ++j)
      if (j < valid) p[j] = e[j];
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
    gate_silu_fwd_kernel(const T* __restrict__ y, int64_t y_row_stride, const T* __restrict__ z,
                         int64_t z_row_stride, T* __restrict__ out, int64_t rows, int I) {
  constexpr int C = Piece<T>::C;
  constexpr int TILE = THREADS_Y * FWD_R;
  const int c0 = (blockIdx.x * THREADS_X + threadIdx.x) * C;
  if (c0 >= I) return;
  const int valid = min(C, I - c0);
  for (int64_t base = static_cast<int64_t>(blockIdx.y) * TILE + threadIdx.y; base < rows;
       base += static_cast<int64_t>(gridDim.y) * TILE) {
    Piece<T> py[FWD_R], pz[FWD_R];
#pragma unroll
    for (int u = 0; u < FWD_R; ++u) {
      const int64_t r = base + u * THREADS_Y;
      py[u] = load_piece<T, VEC>(y + r * y_row_stride + c0, valid, r < rows);
      pz[u] = load_piece<T, VEC>(z + r * z_row_stride + c0, valid, r < rows);
    }
#pragma unroll
    for (int u = 0; u < FWD_R; ++u) {
      const int64_t r = base + u * THREADS_Y;
      float vy[C], vz[C], o[C];
      widen(py[u], vy);
      widen(pz[u], vz);
#pragma unroll
      for (int j = 0; j < C; ++j) o[j] = vy[j] * (vz[j] / (1.f + expf(-vz[j])));
      if (r < rows) store_piece<T, VEC>(out + r * I + c0, o, valid);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
    gate_silu_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ y, int64_t y_row_stride,
                         const T* __restrict__ z, int64_t z_row_stride, T* __restrict__ dy, T* __restrict__ dz,
                         int64_t rows, int I) {
  constexpr int C = Piece<T>::C;
  constexpr int TILE = THREADS_Y * BWD_R;
  const int c0 = (blockIdx.x * THREADS_X + threadIdx.x) * C;
  if (c0 >= I) return;
  const int valid = min(C, I - c0);
  for (int64_t base = static_cast<int64_t>(blockIdx.y) * TILE + threadIdx.y; base < rows;
       base += static_cast<int64_t>(gridDim.y) * TILE) {
    Piece<T> pg[BWD_R], py[BWD_R], pz[BWD_R];
#pragma unroll
    for (int u = 0; u < BWD_R; ++u) {
      const int64_t r = base + u * THREADS_Y;
      pg[u] = load_piece<T, VEC>(dout + r * I + c0, valid, r < rows);
      py[u] = load_piece<T, VEC>(y + r * y_row_stride + c0, valid, r < rows);
      pz[u] = load_piece<T, VEC>(z + r * z_row_stride + c0, valid, r < rows);
    }
#pragma unroll
    for (int u = 0; u < BWD_R; ++u) {
      const int64_t r = base + u * THREADS_Y;
      float g[C], vy[C], vz[C], d_y[C], d_z[C];
      widen(pg[u], g);
      widen(py[u], vy);
      widen(pz[u], vz);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float den = 1.f + expf(-vz[j]), s = 1.f / den;
        d_y[j] = g[j] * (vz[j] / den);
        d_z[j] = (g[j] * vy[j]) * s * (1.f + vz[j] * (1.f - s));
      }
      if (r < rows) {
        store_piece<T, VEC>(dy + r * I + c0, d_y, valid);
        store_piece<T, VEC>(dz + r * I + c0, d_z, valid);
      }
    }
  }
}

template <int R>
dim3 grid_of(int64_t rows, int I, int C) {
  const int64_t tiles = (rows + THREADS_Y * R - 1) / (THREADS_Y * R);
  return dim3((I + THREADS_X * C - 1) / (THREADS_X * C), static_cast<unsigned>(tiles < MAX_GRID_Y ? tiles : MAX_GRID_Y));
}

template <typename T, bool VEC>
void launch_fwd(const void* y, long long ys, const void* z, long long zs, void* out, long long rows, int I,
                cudaStream_t s) {
  gate_silu_fwd_kernel<T, VEC><<<grid_of<FWD_R>(rows, I, Piece<T>::C), dim3(THREADS_X, THREADS_Y), 0, s>>>(
      static_cast<const T*>(y), ys, static_cast<const T*>(z), zs, static_cast<T*>(out), rows, I);
}

template <typename T, bool VEC>
void launch_bwd(const void* dout, const void* y, long long ys, const void* z, long long zs, void* dy, void* dz,
                long long rows, int I, cudaStream_t s) {
  gate_silu_bwd_kernel<T, VEC><<<grid_of<BWD_R>(rows, I, Piece<T>::C), dim3(THREADS_X, THREADS_Y), 0, s>>>(
      static_cast<const T*>(dout), static_cast<const T*>(y), ys, static_cast<const T*>(z), zs, static_cast<T*>(dy),
      static_cast<T*>(dz), rows, I);
}

}  // namespace

extern "C" {

// `dtype`: 0 bf16, 1 f32, for every tensor. `vec`: every pointer 16-byte aligned, I and both row strides
// whole 16-byte pieces. Rows are `rows` apart by the given strides (out, dout, dy and dz: I).
int mlpt_gate_silu_fwd(const void* y, long long y_row_stride, const void* z, long long z_row_stride, void* out,
                       long long rows, int I, int dtype, int vec, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  if (rows <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    vec ? launch_fwd<__nv_bfloat16, true>(y, y_row_stride, z, z_row_stride, out, rows, I, s)
        : launch_fwd<__nv_bfloat16, false>(y, y_row_stride, z, z_row_stride, out, rows, I, s);
  else if (dtype == 1)
    vec ? launch_fwd<float, true>(y, y_row_stride, z, z_row_stride, out, rows, I, s)
        : launch_fwd<float, false>(y, y_row_stride, z, z_row_stride, out, rows, I, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int mlpt_gate_silu_bwd(const void* dout, const void* y, long long y_row_stride, const void* z,
                       long long z_row_stride, void* dy, void* dz, long long rows, int I, int dtype, int vec,
                       void* stream) {
  (void)cudaGetLastError();
  if (rows <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    vec ? launch_bwd<__nv_bfloat16, true>(dout, y, y_row_stride, z, z_row_stride, dy, dz, rows, I, s)
        : launch_bwd<__nv_bfloat16, false>(dout, y, y_row_stride, z, z_row_stride, dy, dz, rows, I, s);
  else if (dtype == 1)
    vec ? launch_bwd<float, true>(dout, y, y_row_stride, z, z_row_stride, dy, dz, rows, I, s)
        : launch_bwd<float, false>(dout, y, y_row_stride, z, z_row_stride, dy, dz, rows, I, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
