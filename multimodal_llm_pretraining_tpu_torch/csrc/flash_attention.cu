// Flash-attention split backward for NVIDIA Hopper (sm_90a): the dq kernel
// and the dk/dv kernel. The forward is csrc/flash_fwd.cu, the fused backward
// csrc/flash_bwd.cu.
//
// Replaces the Pallas TPU kernels of multimodal_llm_pretraining_tpu/ops/flash_attention.py:
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel     (flash_attention.py:161, launched at :572)
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel    (flash_attention.py:293, launched at :589)
//
// Layout: q/k/v/do are row-major [BH, S, D] (batch*heads folded), lse and
// delta are f32 [BH, S]. Products run on the tensor cores through
// nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulation; f32 inputs are
// rounded to bf16 as they land in shared memory, which is what a
// default-precision f32 dot does on the TPU. Softmax statistics, dk/dv and dq
// accumulate in f32.
//
// The split backward (the JAX package's MLPT_FLASH_FUSED_BWD=0 path) does 7
// tile products where the fused one does 5: s and dp are computed twice, once
// per q block for dq and once per k block for dk/dv. In exchange it adds no
// partial sums across blocks, so all three gradients repeat bit for bit.
// * flash_bwd_dq_kernel keeps its [64 x D] f32 dq accumulator in wmma
//   accumulator fragments, in registers (64 of them a thread at D=256, 8
//   warps), not in shared memory: that frees the 66 KB a shared f32
//   accumulator would take at D=256, so 64-row k tiles still fit (~180 KB),
//   and dq is stored once, in the output dtype, with no atomics.
// * flash_bwd_dkv_kernel keeps its k*scale, v, a 64-row q and dO tile and f32
//   dk/dv accumulators in shared memory, with 32-row k blocks (~197 KB at
//   D=256, opting in to the large dynamic shared memory with
//   cudaFuncSetAttribute). The TPU's halved blocks at D > 128
//   (flash_attention.py:568-570) were a VMEM artifact and are not carried over.
// Both still use wmma and no warp specialisation: their Hopper redesign is
// later work.
//
// Sequence tails (S=2049 is not a multiple of any block) are masked in-kernel:
// rows past the end load as zeros and are never stored, keys past the end
// and (causal) keys after the query get probability 0. A query row with no
// visible key produces 0, as the TPU kernel's l_safe guard does.
//
// Varlen (padded-batch) mode, the TPU kernels' varlen=True (_flash_varlen,
// flash_attention.py:622-652): a nullable int32 kv_lens [BH] gives each
// batch-head its own key count, read on the device (no host sync). Only the
// loop bounds and the key masks take it: keys at or past kv_len get
// probability 0, a k block wholly past it runs no q block, and the per-head
// offsets keep the tensor's kv_seq. Every query row, padded or not, attends
// the keys below kv_len. dk and dv rows in [kv_len, kv_seq) are stored as
// exact zeros. kv_lens == nullptr is the plain mode (kv_len = kv_seq).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// This batch-head's key count: kv_lens[bh] clamped to [0, kv_seq], or kv_seq.
__device__ __forceinline__ int key_count(const int* kv_lens, int bh, int kv_seq) {
  return kv_lens == nullptr ? kv_seq : min(max(kv_lens[bh], 0), kv_seq);
}

// ---------------------------------------------------------------- element I/O
// Eight consecutive elements to/from f32 registers (16-byte vector accesses).

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Rows [row0, row0 + rows) of a [S, D] matrix into a bf16 shared tile with row
// stride ld, each element multiplied by `scale` in f32 and rounded once (the
// TPU kernels fold sm_scale the same way). Rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(bf16* tile, int ld, const T* src, int row0, int rows, int valid,
                                          float scale) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    float v[8];
    if (row0 + r < valid) {
      load8(src + (size_t)(row0 + r) * D + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    store8(tile + r * ld + c, v);
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ---------------------------------------------------------------- split backward

constexpr int BWD_BQ = 64, BWD_BK = 32, BWD_THREADS = 256;  // 8 warps

template <int D>
struct BwdSmem {
  static constexpr int LDB = D + 8;       // bf16 tiles
  static constexpr int LDF = D + 4;       // f32 dk/dv accumulators
  static constexpr int LDS = BWD_BK + 4;  // f32 s and dp tiles
  static constexpr int LDP = BWD_BK + 8;  // bf16 p and ds tiles
  static constexpr size_t ks = 0;
  static constexpr size_t v = ks + sizeof(bf16) * BWD_BK * LDB;
  static constexpr size_t q = v + sizeof(bf16) * BWD_BK * LDB;
  static constexpr size_t dout = q + sizeof(bf16) * BWD_BQ * LDB;
  static constexpr size_t dk = dout + sizeof(bf16) * BWD_BQ * LDB;
  static constexpr size_t dv = dk + sizeof(float) * BWD_BK * LDF;
  static constexpr size_t s = dv + sizeof(float) * BWD_BK * LDF;
  static constexpr size_t dp = s + sizeof(float) * BWD_BQ * LDS;
  static constexpr size_t p = dp + sizeof(float) * BWD_BQ * LDS;
  static constexpr size_t ds = p + sizeof(bf16) * BWD_BQ * LDP;
  static constexpr size_t lse = ds + sizeof(bf16) * BWD_BQ * LDP;
  static constexpr size_t delta = lse + sizeof(float) * BWD_BQ;
  static constexpr size_t bytes = delta + sizeof(float) * BWD_BQ;
};

// dk and dv only, one block per (k block, batch-head), looping over q blocks
// from the causal start: the TPU's _bwd_dkv_kernel, the scale folded into k
// for the scores. Per q block: s = q . (k*scale)^T, dp = dO . v^T, p = exp(s
// - lse), ds = p * (dp - delta) * scale; dv += p^T . dO and dk += ds^T . q
// stay in shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kv_lens, T* __restrict__ dk, T* __restrict__ dv, int q_seq,
                         int kv_seq, int causal, float sm_scale) {
  using L = BwdSmem<D>;
  constexpr int NF = D / 16;  // 16-wide column fragments across the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sKs = reinterpret_cast<bf16*>(smem + L::ks);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::dout);
  float* sdK = reinterpret_cast<float*>(smem + L::dk);
  float* sdV = reinterpret_cast<float*>(smem + L::dv);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sdP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  bf16* sdS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BWD_BK;
  const size_t qoff = (size_t)bh * q_seq, koff = (size_t)bh * kv_seq;
  const int kv_len = key_count(kv_lens, bh, kv_seq);

  // the TPU kernel folds the scale into k for the scores; q stays unscaled
  // for dk = ds^T . q
  load_tile<T, D>(sKs, L::LDB, k + koff * D, k0, BWD_BK, kv_len, sm_scale);
  load_tile<T, D>(sV, L::LDB, v + koff * D, k0, BWD_BK, kv_len, 1.f);
  for (int i = threadIdx.x; i < BWD_BK * L::LDF; i += blockDim.x) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }
  // a k block wholly past kv_len sees no query: it runs no iteration and
  // stores its zeroed dk/dv below
  const int num_qb = k0 < kv_len ? cdiv(q_seq, BWD_BQ) : 0;
  const int qb_start = causal ? k0 / BWD_BQ : 0;

  for (int qb = qb_start; qb < num_qb; ++qb) {
    const int q0 = qb * BWD_BQ;
    load_tile<T, D>(sQ, L::LDB, q + qoff * D, q0, BWD_BQ, q_seq, 1.f);
    load_tile<T, D>(sdO, L::LDB, dout + qoff * D, q0, BWD_BQ, q_seq, 1.f);
    if (threadIdx.x < BWD_BQ) {
      const bool in = q0 + threadIdx.x < q_seq;
      sLse[threadIdx.x] = in ? lse[qoff + q0 + threadIdx.x] : 0.f;
      sDelta[threadIdx.x] = in ? delta[qoff + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    // s and dp, [64 x 32] each: one 16x16 fragment of each per warp
    {
      const int fr = (warp >> 1) * 16, fc = (warp & 1) * 16;
      FragC s_acc, dp_acc;
      wmma::fill_fragment(s_acc, 0.f);
      wmma::fill_fragment(dp_acc, 0.f);
      for (int d0 = 0; d0 < D; d0 += 16) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, sQ + fr * L::LDB + d0, L::LDB);
        wmma::load_matrix_sync(b, sKs + fc * L::LDB + d0, L::LDB);
        wmma::mma_sync(s_acc, a, b, s_acc);
        wmma::load_matrix_sync(a, sdO + fr * L::LDB + d0, L::LDB);
        wmma::load_matrix_sync(b, sV + fc * L::LDB + d0, L::LDB);
        wmma::mma_sync(dp_acc, a, b, dp_acc);
      }
      wmma::store_matrix_sync(sS + fr * L::LDS + fc, s_acc, L::LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(sdP + fr * L::LDS + fc, dp_acc, L::LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // p = exp(s - lse) on visible entries, ds = p * (dp - delta) * scale
    for (int i = threadIdx.x; i < BWD_BQ * BWD_BK; i += blockDim.x) {
      const int r = i / BWD_BK, c = i % BWD_BK;
      const int qi = q0 + r, ki = k0 + c;
      const bool ok = qi < q_seq && ki < kv_len && (!causal || qi >= ki);
      const float p = ok ? expf(sS[r * L::LDS + c] - sLse[r]) : 0.f;
      const float ds = p * (sdP[r * L::LDS + c] - sDelta[r]) * sm_scale;
      sP[r * L::LDP + c] = __float2bfloat16(p);
      sdS[r * L::LDP + c] = __float2bfloat16(ds);
    }
    __syncthreads();

    // dv += p^T . dO and dk += ds^T . q, [32 x D] each
    for (int f = warp; f < 2 * NF; f += BWD_THREADS / 32) {
      const int fr = (f / NF) * 16, fc = (f % NF) * 16;
      FragC dv_acc, dk_acc;
      wmma::load_matrix_sync(dv_acc, sdV + fr * L::LDF + fc, L::LDF, wmma::mem_row_major);
      wmma::load_matrix_sync(dk_acc, sdK + fr * L::LDF + fc, L::LDF, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BWD_BQ; kk += 16) {
        FragAT a;
        FragB b;
        wmma::load_matrix_sync(a, sP + kk * L::LDP + fr, L::LDP);
        wmma::load_matrix_sync(b, sdO + kk * L::LDB + fc, L::LDB);
        wmma::mma_sync(dv_acc, a, b, dv_acc);
        wmma::load_matrix_sync(a, sdS + kk * L::LDP + fr, L::LDP);
        wmma::load_matrix_sync(b, sQ + kk * L::LDB + fc, L::LDB);
        wmma::mma_sync(dk_acc, a, b, dk_acc);
      }
      wmma::store_matrix_sync(sdV + fr * L::LDF + fc, dv_acc, L::LDF, wmma::mem_row_major);
      wmma::store_matrix_sync(sdK + fr * L::LDF + fc, dk_acc, L::LDF, wmma::mem_row_major);
    }

    __syncthreads();  // the q/dO tiles are reused next iteration
  }
  // a k block no query sees (causal with kv_seq > q_seq, or wholly past
  // kv_len) runs no iteration: the zeroed accumulators still need a barrier
  // before other threads read them. Rows in [kv_len, kv_seq) store zeros.
  __syncthreads();

  for (int i = threadIdx.x; i < BWD_BK * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (k0 + r < kv_seq) {
      store8(dk + (koff + k0 + r) * D + c, sdK + r * L::LDF + c);
      store8(dv + (koff + k0 + r) * D + c, sdV + r * L::LDF + c);
    }
  }
}

constexpr int DQ_BQ = 64, DQ_BK = 64, DQ_THREADS = 256;  // 8 warps

template <int D>
struct DqSmem {
  static constexpr int LDB = D + 8;      // bf16 tiles
  static constexpr int LDS = DQ_BK + 4;  // f32 s and dp tiles
  static constexpr int LDP = DQ_BK + 8;  // bf16 ds tile
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + sizeof(bf16) * DQ_BQ * LDB;
  static constexpr size_t k = dout + sizeof(bf16) * DQ_BQ * LDB;
  static constexpr size_t v = k + sizeof(bf16) * DQ_BK * LDB;
  static constexpr size_t s = v + sizeof(bf16) * DQ_BK * LDB;
  static constexpr size_t dp = s + sizeof(float) * DQ_BQ * LDS;
  static constexpr size_t ds = dp + sizeof(float) * DQ_BQ * LDS;
  static constexpr size_t lse = ds + sizeof(bf16) * DQ_BQ * LDP;
  static constexpr size_t delta = lse + sizeof(float) * DQ_BQ;
  static constexpr size_t bytes = delta + sizeof(float) * DQ_BQ;
};

// dq only, one block per (q block, batch-head): the TPU's _bwd_dq_kernel.
// The scale folds into q for the scores, ds = p * (dp - delta) * scale is
// rounded to the operand type, and dq += ds . k takes the *unscaled* k
// (flash_attention.py:172-195). Each warp owns NF/2 of the [64 x D] dq
// accumulator's 16x16 fragments for the whole k loop; dq is stored once.
template <typename T, int D>
__global__ void __launch_bounds__(DQ_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kv_lens, T* __restrict__ dq, int q_seq, int kv_seq, int causal,
                        float sm_scale) {
  using L = DqSmem<D>;
  constexpr int NF = D / 16;
  constexpr int WARPS = DQ_THREADS / 32;
  constexpr int NACC = (DQ_BQ / 16) * NF / WARPS;  // dq fragments per warp
  constexpr int NSF = (DQ_BQ / 16) * (DQ_BK / 16);  // s (and dp) fragments per k tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sdO = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sdP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sdS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  // causal: the last q blocks see the most keys; launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;
  const size_t qoff = (size_t)bh * q_seq, koff = (size_t)bh * kv_seq;
  const int kv_len = key_count(kv_lens, bh, kv_seq);

  load_tile<T, D>(sQ, L::LDB, q + qoff * D, q0, DQ_BQ, q_seq, sm_scale);
  load_tile<T, D>(sdO, L::LDB, dout + qoff * D, q0, DQ_BQ, q_seq, 1.f);
  if (threadIdx.x < DQ_BQ) {
    const bool in = q0 + threadIdx.x < q_seq;
    sLse[threadIdx.x] = in ? lse[qoff + q0 + threadIdx.x] : 0.f;
    sDelta[threadIdx.x] = in ? delta[qoff + q0 + threadIdx.x] : 0.f;
  }
  FragC acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) wmma::fill_fragment(acc[j], 0.f);
  int num_kb = cdiv(kv_len, DQ_BK);
  if (causal) num_kb = min(num_kb, cdiv(q0 + DQ_BQ, DQ_BK));

  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * DQ_BK;
    load_tile<T, D>(sK, L::LDB, k + koff * D, k0, DQ_BK, kv_len, 1.f);
    load_tile<T, D>(sV, L::LDB, v + koff * D, k0, DQ_BK, kv_len, 1.f);
    __syncthreads();

    // s and dp, [64 x 64] each: two 16x16 fragments of each per warp
    for (int f = warp; f < NSF; f += WARPS) {
      const int fr = (f / (DQ_BK / 16)) * 16, fc = (f % (DQ_BK / 16)) * 16;
      FragC s_acc, dp_acc;
      wmma::fill_fragment(s_acc, 0.f);
      wmma::fill_fragment(dp_acc, 0.f);
      for (int d0 = 0; d0 < D; d0 += 16) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, sQ + fr * L::LDB + d0, L::LDB);
        wmma::load_matrix_sync(b, sK + fc * L::LDB + d0, L::LDB);
        wmma::mma_sync(s_acc, a, b, s_acc);
        wmma::load_matrix_sync(a, sdO + fr * L::LDB + d0, L::LDB);
        wmma::load_matrix_sync(b, sV + fc * L::LDB + d0, L::LDB);
        wmma::mma_sync(dp_acc, a, b, dp_acc);
      }
      wmma::store_matrix_sync(sS + fr * L::LDS + fc, s_acc, L::LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(sdP + fr * L::LDS + fc, dp_acc, L::LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // p = exp(s - lse) on visible entries, ds = p * (dp - delta) * scale
    for (int i = threadIdx.x; i < DQ_BQ * DQ_BK; i += blockDim.x) {
      const int r = i / DQ_BK, c = i % DQ_BK;
      const int qi = q0 + r, ki = k0 + c;
      const bool ok = qi < q_seq && ki < kv_len && (!causal || qi >= ki);
      const float p = ok ? expf(sS[r * L::LDS + c] - sLse[r]) : 0.f;
      sdS[r * L::LDP + c] = __float2bfloat16(p * (sdP[r * L::LDS + c] - sDelta[r]) * sm_scale);
    }
    __syncthreads();

    // dq += ds . k on this warp's fragments
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int f = warp + j * WARPS;
      const int fr = (f / NF) * 16, fc = (f % NF) * 16;
#pragma unroll
      for (int kk = 0; kk < DQ_BK; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sdS + fr * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(b, sK + kk * L::LDB + fc, L::LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // the k/v/ds tiles are overwritten next iteration
  }

  // store dq in the output dtype through a per-warp 16x16 f32 scratch (the s
  // tile is free now); a row with no visible key stores 0
  float* scratch = sS + warp * 256;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int f = warp + j * WARPS;
    const int fr = (f / NF) * 16, fc = (f % NF) * 16;
    wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int r = lane / 2, c = (lane % 2) * 8, qi = q0 + fr + r;
    if (qi < q_seq) store8(dq + (qoff + qi) * D + fc + c, scratch + r * 16 + c);
    __syncwarp();
  }
}

// ---------------------------------------------------------------- launchers

template <typename T, int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
                  const int* kv_lens, void* dq, int bh, int q_seq, int kv_seq, int causal, float sm_scale,
                  cudaStream_t stream) {
  constexpr size_t smem = DqSmem<D>::bytes;
  static_assert(smem <= 232448, "dq tile set exceeds the 227 KB a block may use");
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(q_seq, DQ_BQ), bh);
  flash_bwd_dq_kernel<T, D><<<grid, DQ_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      delta, kv_lens, static_cast<T*>(dq), q_seq, kv_seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, const int* kv_lens, void* dk, void* dv, int bh, int q_seq, int kv_seq,
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = BwdSmem<D>::bytes;
  static_assert(smem <= 232448, "dk/dv tile set exceeds the 227 KB a block may use");
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(kv_seq, BWD_BK), bh);
  flash_bwd_dkv_kernel<T, D><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      delta, kv_lens, static_cast<T*>(dk), static_cast<T*>(dv), q_seq, kv_seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = bfloat16, 1 = float32.
// kv_lens: int32 [BH] on the device for the varlen mode, or nullptr. Each
// returns the cudaError_t of its launch (0 on success); nothing is allocated
// and nothing synchronises.
extern "C" {

const char* mlpt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// The split backward: dq [BH, Sq, D] in the input dtype, no zeroing needed.
int mlpt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, const int* kv_lens, void* dq, int bh, int q_seq, int kv_seq, int head_dim,
                      int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();
#define MLPT_DQ(T, D) \
  return launch_bwd_dq<T, D>(q, k, v, dout, lse, delta, kv_lens, dq, bh, q_seq, kv_seq, causal, sm_scale, s)
  if (dtype == 0) {
    if (head_dim == 64) MLPT_DQ(bf16, 64);
    if (head_dim == 128) MLPT_DQ(bf16, 128);
    if (head_dim == 256) MLPT_DQ(bf16, 256);
  } else if (dtype == 1) {
    if (head_dim == 64) MLPT_DQ(float, 64);
    if (head_dim == 128) MLPT_DQ(float, 128);
    if (head_dim == 256) MLPT_DQ(float, 256);
  }
#undef MLPT_DQ
  return (int)cudaErrorInvalidValue;
}

int mlpt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, const int* kv_lens, void* dk, void* dv, int bh, int q_seq, int kv_seq,
                       int head_dim, int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();
#define MLPT_DKV(T, D) \
  return launch_bwd_dkv<T, D>(q, k, v, dout, lse, delta, kv_lens, dk, dv, bh, q_seq, kv_seq, causal, sm_scale, s)
  if (dtype == 0) {
    if (head_dim == 64) MLPT_DKV(bf16, 64);
    if (head_dim == 128) MLPT_DKV(bf16, 128);
    if (head_dim == 256) MLPT_DKV(bf16, 256);
  } else if (dtype == 1) {
    if (head_dim == 64) MLPT_DKV(float, 64);
    if (head_dim == 128) MLPT_DKV(float, 128);
    if (head_dim == 256) MLPT_DKV(float, 256);
  }
#undef MLPT_DKV
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
