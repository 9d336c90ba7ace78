// Mamba selective scan for NVIDIA Hopper (sm_90a): forward and reverse-time backward.
//
// Replaces the Pallas TPU kernels of multimodal_llm_pretraining_tpu/ops/selective_scan_pallas.py:
//   scan_fwd_kernel  <- _scan_kernel      (selective_scan_pallas.py:47, launched by selective_scan_pallas_fwd)
//   scan_bwd_kernel  <- _scan_bwd_kernel  (selective_scan_pallas.py:161, launched by selective_scan_pallas_bwd)
//
// The recurrence, per batch b, channel i and state n, all in f32:
//   da_t = exp(delta_t[i] * A[i, n]),   h_t = da_t * h_{t-1} + (delta_t[i] * u_t[i]) * B_t[n]
//   y_t[i] = sum_n C_t[n] * h_t[n]                                   (before the D skip)
// Layout: u, delta [B, L, I] and B, C [B, L, N] row-major, bf16 or f32 (one dtype
// for the four); A f32 [I, N]; y, dy, du, ddelta f32 [B, L, I]. The state
// checkpoint is f32 [B, ceil(L / 256), N, I]: the state entering each 256-step
// chunk, as the TPU kernel's with_checkpoints output.
//
// What bounds these kernels on this card, and what the design does about it:
// * The sequential carry. The TPU grid (batch, I-block, L-chunk) runs in order,
//   so the state h lives in VMEM scratch and carries from chunk to chunk. GPU
//   blocks run in parallel and in no order, so the whole L loop lives inside
//   one block per (batch, 32 channels), and the carry inside each thread's
//   registers. Each channel gets 16 lanes, one per state n: half a warp per
//   channel, 512 threads per block. y_t is a 16-lane shuffle reduction.
// * Memory traffic. Materialising the discretized [L, I, N] tensors would cost
//   O(L * I * N) bytes of device memory; here they exist only in registers, so
//   traffic stays O(L * I). Inputs stage through shared memory one tile of
//   time steps at a time, loaded coalesced across channels; within the tile
//   delta and u are broadcasts to the 16 lanes of a channel, B_t and C_t are
//   per-lane reads of 16 consecutive words.
// * Latency, not bandwidth or FLOPs. Every step is a dependent
//   exp -> fma chain, and a thread owns one state, so the card is filled by
//   many resident warps (B * I * 16 threads), not by work per thread.
// * Reverse-time recompute. The backward needs h_{t-1} at every t, walking back
//   in time. It reads the chunk's entry state from the checkpoint and
//   recomputes in two levels, as the TPU kernel does with hmid: pass 1 runs the
//   chunk forward and keeps each 16-step group's entry state in shared memory;
//   pass 2 walks the groups backwards, recomputes the group's 16 states into
//   registers, and walks them backwards accumulating every cotangent.
// * Cross-block sums without atomics. du and ddelta belong to one channel and
//   are written directly. dB_t[n] and dC_t[n] sum over channels: each block
//   reduces its 32 channels in a fixed order (a shuffle across the two
//   channels of a warp, then the 16 warps in order) and writes a partial per
//   channel block, [n_iblocks, B, L, N]; dA sums over batch and is written per
//   batch, [B, N, I]. The wrapper sums the partials, so a second run repeats
//   the first bit for bit.
// * TPU tiling artifacts dropped: no L padding (the tail of the last tile
//   loads as delta = 0, an identity transition, and is never stored), no N
//   padding (N must be 16, Mamba's d_state; the entry points refuse others),
//   no 8-step sublane groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int NS = 16;             // d_state: one lane per state
constexpr int CH = 32;             // channels per block
constexpr int THREADS = CH * NS;   // 512
constexpr int NWARPS = THREADS / 32;
constexpr int CHUNK = 256;         // checkpoint interval (the TPU kernel's block_l)
constexpr int FWD_TILE = 64;       // forward: time steps staged per tile
constexpr int GROUP = 16;          // backward: time steps per recompute group
constexpr int GROUPS = CHUNK / GROUP;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// Sum over the 16 lanes of a half warp (one channel's states).
__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(FULL, v, 8);
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 2);
  v += __shfl_xor_sync(FULL, v, 1);
  return v;
}

// Stage `rows` time steps from t0 of the [B, L, I] streams (channels i0..i0+CH)
// and the [B, L, N] streams into shared memory; steps past L and channels past
// I load as 0.
template <typename T>
__device__ __forceinline__ void stage_channels(float* dst, const T* src, size_t row0, int t0, int rows, int L, int I,
                                               int i0) {
  for (int k = threadIdx.x; k < rows * CH; k += THREADS) {
    const int tt = k / CH, cc = k % CH, t = t0 + tt, i = i0 + cc;
    dst[k] = (t < L && i < I) ? to_f(src[(row0 + t) * I + i]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void stage_states(float* dst, const T* src, size_t row0, int t0, int rows, int L) {
  for (int k = threadIdx.x; k < rows * NS; k += THREADS) {
    const int tt = k / NS, nn = k % NS, t = t0 + tt;
    dst[k] = t < L ? to_f(src[(row0 + t) * NS + nn]) : 0.f;
  }
}

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(THREADS) scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                                                           const float* __restrict__ A, const T* __restrict__ Bm,
                                                           const T* __restrict__ Cm, float* __restrict__ y,
                                                           float* __restrict__ ckpt, int L, int I) {
  __shared__ float s_delta[FWD_TILE * CH], s_u[FWD_TILE * CH], s_y[FWD_TILE * CH];
  __shared__ float s_B[FWD_TILE * NS], s_C[FWD_TILE * NS];

  const int b = blockIdx.y, i0 = blockIdx.x * CH;
  const int c = threadIdx.x / NS, n = threadIdx.x % NS, i = i0 + c;
  const bool active = i < I;
  const float a_n = active ? A[(size_t)i * NS + n] : 0.f;
  const size_t row0 = (size_t)b * L;
  const int n_chunks = cdiv(L, CHUNK);
  float h = 0.f;

  for (int t0 = 0; t0 < L; t0 += FWD_TILE) {
    if (ckpt != nullptr && t0 % CHUNK == 0 && active)
      ckpt[(((size_t)b * n_chunks + t0 / CHUNK) * NS + n) * I + i] = h;  // state entering the chunk
    __syncthreads();  // the previous tile's s_y has been stored
    stage_channels(s_delta, delta, row0, t0, FWD_TILE, L, I, i0);
    stage_channels(s_u, u, row0, t0, FWD_TILE, L, I, i0);
    stage_states(s_B, Bm, row0, t0, FWD_TILE, L);
    stage_states(s_C, Cm, row0, t0, FWD_TILE, L);
    __syncthreads();

    const int steps = min(FWD_TILE, L - t0);
    for (int tt = 0; tt < steps; ++tt) {
      const float d = s_delta[tt * CH + c];
      h = __expf(d * a_n) * h + (d * s_u[tt * CH + c]) * s_B[tt * NS + n];
      const float p = sum16(h * s_C[tt * NS + n]);
      if (n == 0) s_y[tt * CH + c] = p;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < steps * CH; k += THREADS) {
      const int tt = k / CH, ii = i0 + k % CH;
      if (ii < I) y[(row0 + t0 + tt) * I + ii] = s_y[k];
    }
  }
}

// ---------------------------------------------------------------- backward

// Dynamic shared memory of the backward block, in floats.
struct BwdSmem {
  static constexpr int delta = 0;
  static constexpr int u = delta + GROUP * CH;
  static constexpr int dy = u + GROUP * CH;
  static constexpr int du = dy + GROUP * CH;
  static constexpr int ddelta = du + GROUP * CH;
  static constexpr int B = ddelta + GROUP * CH;
  static constexpr int C = B + GROUP * NS;
  static constexpr int pB = C + GROUP * NS;           // [NWARPS][GROUP][NS] per-warp dB partials
  static constexpr int pC = pB + NWARPS * GROUP * NS;  // same for dC
  static constexpr int hmid = pC + NWARPS * GROUP * NS;  // [GROUPS][THREADS] group entry states
  static constexpr int total = hmid + GROUPS * THREADS;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta, const float* __restrict__ A,
                    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ dy,
                    const float* __restrict__ ckpt, float* __restrict__ du, float* __restrict__ ddelta,
                    float* __restrict__ dA_part, float* __restrict__ dB_part, float* __restrict__ dC_part, int batch,
                    int L, int I) {
  extern __shared__ float smem[];
  float* s_delta = smem + BwdSmem::delta;
  float* s_u = smem + BwdSmem::u;
  float* s_dy = smem + BwdSmem::dy;
  float* s_du = smem + BwdSmem::du;
  float* s_dd = smem + BwdSmem::ddelta;
  float* s_B = smem + BwdSmem::B;
  float* s_C = smem + BwdSmem::C;
  float* s_pB = smem + BwdSmem::pB;
  float* s_pC = smem + BwdSmem::pC;
  float* s_hmid = smem + BwdSmem::hmid;

  const int b = blockIdx.y, ib = blockIdx.x, i0 = ib * CH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = tid / NS, n = tid % NS, i = i0 + c;
  const bool active = i < I;
  const float a_n = active ? A[(size_t)i * NS + n] : 0.f;
  const size_t row0 = (size_t)b * L;
  const int n_chunks = cdiv(L, CHUNK);

  float G = 0.f;       // da_{t+1} * gh_{t+1}: the reverse carry
  float dA_acc = 0.f;  // sum over t of gh * h_{t-1} * da_t * delta_t

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int c0 = k * CHUNK;
    const int n_groups = cdiv(min(CHUNK, L - c0), GROUP);
    float h = active ? ckpt[(((size_t)b * n_chunks + k) * NS + n) * I + i] : 0.f;

    // pass 1: run the chunk forward from its checkpoint, keeping each group's entry state
    for (int g = 0; g < n_groups; ++g) {
      const int t0 = c0 + g * GROUP;
      s_hmid[g * THREADS + tid] = h;
      __syncthreads();
      stage_channels(s_delta, delta, row0, t0, GROUP, L, I, i0);
      stage_channels(s_u, u, row0, t0, GROUP, L, I, i0);
      stage_states(s_B, Bm, row0, t0, GROUP, L);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        const float d = s_delta[s * CH + c];
        h = __expf(d * a_n) * h + (d * s_u[s * CH + c]) * s_B[s * NS + n];
      }
    }

    // pass 2: groups in reverse; recompute the group's states, then walk them back
    for (int g = n_groups - 1; g >= 0; --g) {
      const int t0 = c0 + g * GROUP;
      __syncthreads();  // the previous group's outputs have been written out
      stage_channels(s_delta, delta, row0, t0, GROUP, L, I, i0);
      stage_channels(s_u, u, row0, t0, GROUP, L, I, i0);
      stage_channels(s_dy, dy, row0, t0, GROUP, L, I, i0);
      stage_states(s_B, Bm, row0, t0, GROUP, L);
      stage_states(s_C, Cm, row0, t0, GROUP, L);
      __syncthreads();

      const float h_entry = s_hmid[g * THREADS + tid];
      float hs[GROUP], das[GROUP];
      h = h_entry;
#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        const float d = s_delta[s * CH + c];
        das[s] = __expf(d * a_n);
        h = das[s] * h + (d * s_u[s * CH + c]) * s_B[s * NS + n];
        hs[s] = h;
      }
#pragma unroll
      for (int s = GROUP - 1; s >= 0; --s) {
        const float d = s_delta[s * CH + c], uu = s_u[s * CH + c], g_y = s_dy[s * CH + c];
        const float Bn = s_B[s * NS + n], Cn = s_C[s * NS + n];
        const float gh = Cn * g_y + G;
        const float h_prev = s > 0 ? hs[s > 0 ? s - 1 : 0] : h_entry;
        const float common = gh * h_prev * das[s];
        dA_acc += common * d;
        const float sum_a = sum16(common * a_n);
        const float sum_b = sum16(gh * Bn);
        if (n == 0) {
          s_dd[s * CH + c] = sum_a + sum_b * uu;
          s_du[s * CH + c] = sum_b * d;
        }
        // dB_t[n] = sum_i gh * delta * u and dC_t[n] = sum_i h_t * dy: first the warp's two channels
        float pb = gh * (d * uu), pc = hs[s] * g_y;
        pb += __shfl_xor_sync(FULL, pb, 16);
        pc += __shfl_xor_sync(FULL, pc, 16);
        if (lane < NS) {
          s_pB[(warp * GROUP + s) * NS + n] = pb;
          s_pC[(warp * GROUP + s) * NS + n] = pc;
        }
        G = das[s] * gh;
      }
      __syncthreads();

      const int steps = min(GROUP, L - t0);
      for (int kk = tid; kk < steps * CH; kk += THREADS) {
        const int s = kk / CH, ii = i0 + kk % CH;
        if (ii < I) {
          const size_t at = (row0 + t0 + s) * I + ii;
          du[at] = s_du[kk];
          ddelta[at] = s_dd[kk];
        }
      }
      // then the warps in a fixed order: one thread per (step, state) for dB, one for dC
      if (tid < 2 * GROUP * NS) {
        const int which = tid / (GROUP * NS), s = (tid / NS) % GROUP, nn = tid % NS;
        if (s < steps) {
          const float* part = which == 0 ? s_pB : s_pC;
          float acc = 0.f;
          for (int w = 0; w < NWARPS; ++w) acc += part[(w * GROUP + s) * NS + nn];
          float* out = which == 0 ? dB_part : dC_part;
          out[(((size_t)ib * batch + b) * L + t0 + s) * NS + nn] = acc;
        }
      }
    }
  }
  if (active) dA_part[((size_t)b * NS + n) * I + i] = dA_acc;
}

template <typename T>
int launch_fwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, float* y, float* ckpt,
               int batch, int L, int I, cudaStream_t stream) {
  dim3 grid(cdiv(I, CH), batch);
  scan_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(u), static_cast<const T*>(delta), A,
                                                    static_cast<const T*>(Bm), static_cast<const T*>(Cm), y, ckpt, L, I);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, const float* dy,
               const float* ckpt, float* du, float* ddelta, float* dA_part, float* dB_part, float* dC_part, int batch,
               int L, int I, cudaStream_t stream) {
  const size_t smem = BwdSmem::total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(I, CH), batch);
  scan_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), dy, ckpt, du, ddelta, dA_part, dB_part, dC_part, batch, L, I);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C entry points
// dtype: 0 = bf16, 1 = f32 (u, delta, B and C). Return a cudaError_t code, 0 on success.

extern "C" {

int mlpt_scan_fwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, float* y,
                  float* ckpt, int batch, int L, int I, int N, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  if (N != NS || batch <= 0 || L <= 0 || I <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<bf16>(u, delta, A, Bm, Cm, y, ckpt, batch, L, I, s);
  if (dtype == 1) return launch_fwd<float>(u, delta, A, Bm, Cm, y, ckpt, batch, L, I, s);
  return (int)cudaErrorInvalidValue;
}

int mlpt_scan_bwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, const float* dy,
                  const float* ckpt, float* du, float* ddelta, float* dA_part, float* dB_part, float* dC_part,
                  int batch, int L, int I, int N, int dtype, void* stream) {
  (void)cudaGetLastError();
  if (N != NS || batch <= 0 || L <= 0 || I <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<bf16>(u, delta, A, Bm, Cm, dy, ckpt, du, ddelta, dA_part, dB_part, dC_part, batch, L, I, s);
  if (dtype == 1)
    return launch_bwd<float>(u, delta, A, Bm, Cm, dy, ckpt, du, ddelta, dA_part, dB_part, dC_part, batch, L, I, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
