// Flash attention for NVIDIA Hopper (sm_90a): forward and fused backward.
//
// Replaces the Pallas TPU kernels of multimodal_llm_pretraining_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel        (flash_attention.py:91, launched by _fwd_impl)
//   flash_bwd_kernel  <- _bwd_fused_kernel  (flash_attention.py:208, launched by _bwd_impl)
//
// Layout: q/k/v/o/do are row-major [BH, S, D] (batch*heads folded), lse and delta
// are f32 [BH, S]. Products run on the tensor cores through nvcuda::wmma
// 16x16x16 bf16 fragments with f32 accumulation; f32 inputs are rounded to bf16
// as they land in shared memory, which is what a default-precision f32 dot does
// on the TPU. Softmax statistics, dk/dv and dq accumulate in f32.
//
// What bounds these kernels on this card, and what the design does about it:
// * Shared memory. At D=256 a 64-row bf16 tile is 32 KB. The backward keeps its
//   k block's k, k*scale, v tiles, a 64-row q and dO tile, and f32 dk/dv
//   accumulators resident: with 64-row k blocks that is ~270 KB, over the
//   227 KB a block may use. The backward therefore takes 32-row k blocks
//   (~214 KB at D=256); the forward takes 64x64 tiles plus a 64xD f32 output
//   accumulator (~195 KB at D=256). Both opt in to the large dynamic shared
//   memory with cudaFuncSetAttribute.
// * Cross-block reduction. The TPU's grid runs in order, so _bwd_fused_kernel
//   keeps a whole-sequence dq block resident and revisits it from every k
//   program. GPU blocks run in parallel and in no order, so each block adds
//   its ds.k contribution into a zeroed f32 dq buffer with atomicAdd; the
//   summation order, and so the last bits of dq, vary from run to run.
// * Tensor-core rate. wmma issues warp-wide mma.sync; Hopper's full rate needs
//   wgmma, TMA and warp specialisation. Those are later work: this version is
//   written to be right first, one block per SM at D=256.
//
// Sequence tails (S=2049 is not a multiple of any block) are masked in-kernel:
// rows past the end load as zeros and are never stored, keys past the end
// and (causal) keys after the query get probability 0. A query row with no
// visible key produces 0, as the TPU kernel's l_safe guard does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ---------------------------------------------------------------- forward

constexpr int FWD_BQ = 64, FWD_BK = 64, FWD_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
struct FwdSmem {
  static constexpr int LDB = D + 8;       // bf16 q/k/v tiles (padding breaks bank conflicts)
  static constexpr int LDS = FWD_BK + 4;  // f32 scores
  static constexpr int LDP = FWD_BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;       // f32 output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * FWD_BQ * LDB;
  static constexpr size_t v = k + sizeof(bf16) * FWD_BK * LDB;
  static constexpr size_t s = v + sizeof(bf16) * FWD_BK * LDB;
  static constexpr size_t p = s + sizeof(float) * FWD_BQ * LDS;
  static constexpr size_t o = p + sizeof(bf16) * FWD_BQ * LDP;
  static constexpr size_t m = o + sizeof(float) * FWD_BQ * LDO;
  static constexpr size_t l = m + sizeof(float) * FWD_BQ;
  static constexpr size_t alpha = l + sizeof(float) * FWD_BQ;
  static constexpr size_t bytes = alpha + sizeof(float) * FWD_BQ;
};

// One block per (q block, batch-head). The k-block loop carries the online
// softmax (running max m, running sum l) and the f32 output accumulator.
template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int q_seq, int kv_seq, int causal, float sm_scale) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sA = reinterpret_cast<float*>(smem + L::alpha);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  // causal: the last q blocks see the most keys; launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_BQ;
  const T* qb = q + (size_t)bh * q_seq * D;
  const T* kb_base = k + (size_t)bh * kv_seq * D;
  const T* vb_base = v + (size_t)bh * kv_seq * D;

  load_tile<T, D>(sQ, L::LDB, qb, q0, FWD_BQ, q_seq, sm_scale);
  for (int i = threadIdx.x; i < FWD_BQ * L::LDO; i += blockDim.x) sO[i] = 0.f;
  if (threadIdx.x < FWD_BQ) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.f;
  }
  int num_kb = cdiv(kv_seq, FWD_BK);
  if (causal) num_kb = min(num_kb, cdiv(q0 + FWD_BQ, FWD_BK));
  const int r0 = warp * 16;  // this warp's query rows within the block
  __syncthreads();

  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * FWD_BK;
    load_tile<T, D>(sK, L::LDB, kb_base, k0, FWD_BK, kv_seq, 1.f);
    load_tile<T, D>(sV, L::LDB, vb_base, k0, FWD_BK, kv_seq, 1.f);
    __syncthreads();

    // s = (q * scale) . k^T for this warp's 16 rows x 64 keys
    FragC acc[FWD_BK / 16];
#pragma unroll
    for (int j = 0; j < FWD_BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int d0 = 0; d0 < D; d0 += 16) {
      FragA a;
      wmma::load_matrix_sync(a, sQ + r0 * L::LDB + d0, L::LDB);
#pragma unroll
      for (int j = 0; j < FWD_BK / 16; ++j) {
        FragBT b;
        wmma::load_matrix_sync(b, sK + (j * 16) * L::LDB + d0, L::LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FWD_BK / 16; ++j)
      wmma::store_matrix_sync(sS + r0 * L::LDS + j * 16, acc[j], L::LDS, wmma::mem_row_major);
    __syncwarp();

    // online softmax over the warp's rows: each lane owns keys lane, lane+32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, qi = q0 + r;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, ki = k0 + c;
        ok[t] = ki < kv_seq && (!causal || qi >= ki);
        s[t] = ok[t] ? sS[r * L::LDS + c] : NEG_INF;
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = ok[t] ? expf(s[t] - m_new) : 0.f;
        psum += p;
        sP[r * L::LDP + lane + 32 * t] = __float2bfloat16(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncwarp();

    // acc = acc * alpha + p . v  (the accumulator lives in shared memory)
    for (int i = lane; i < 16 * D; i += 32) {
      const int rr = i / D, c = i % D;
      sO[(r0 + rr) * L::LDO + c] *= sA[r0 + rr];
    }
    __syncwarp();
    for (int n0 = 0; n0 < D; n0 += 16) {
      FragC oacc;
      wmma::load_matrix_sync(oacc, sO + r0 * L::LDO + n0, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FWD_BK; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sP + r0 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(b, sV + kk * L::LDB + n0, L::LDB);
        wmma::mma_sync(oacc, a, b, oacc);
      }
      wmma::store_matrix_sync(sO + r0 * L::LDO + n0, oacc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();  // k/v tiles are overwritten next iteration
  }

  // o = acc / l, lse = m + log(l); an empty row (l == 0) gives o = 0
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, qi = q0 + r;
    if (qi >= q_seq) break;
    const float l = sL[r];
    const float l_safe = l > 0.f ? l : 1.f;
    T* orow = o + ((size_t)bh * q_seq + qi) * D;
    for (int c = lane * 8; c < D; c += 32 * 8) {
      float vals[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = sO[r * L::LDO + c + j] / l_safe;
      store8(orow + c, vals);
    }
    if (lane == 0) lse[(size_t)bh * q_seq + qi] = sM[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- fused backward

constexpr int BWD_BQ = 64, BWD_BK = 32, BWD_THREADS = 256;  // 8 warps

template <int D>
struct BwdSmem {
  static constexpr int LDB = D + 8;       // bf16 tiles
  static constexpr int LDF = D + 4;       // f32 dk/dv accumulators
  static constexpr int LDS = BWD_BK + 4;  // f32 s and dp tiles
  static constexpr int LDP = BWD_BK + 8;  // bf16 p and ds tiles
  static constexpr size_t k = 0;
  static constexpr size_t ks = k + sizeof(bf16) * BWD_BK * LDB;
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

// One block per (k block, batch-head), looping over q blocks from the causal
// start. Per q block: s = q . (k*scale)^T, dp = dO . v^T, p = exp(s - lse),
// ds = p * (dp - delta) * scale; dv += p^T . dO and dk += ds^T . q stay in
// shared memory; dq += ds . k goes to global memory by f32 atomicAdd.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int q_seq, int kv_seq,
                     int causal, float sm_scale) {
  using L = BwdSmem<D>;
  constexpr int NF = D / 16;  // 16-wide column fragments across the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
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

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BWD_BK;
  const size_t qoff = (size_t)bh * q_seq, koff = (size_t)bh * kv_seq;

  // the TPU kernel folds the scale into k for the scores; q stays unscaled
  // for dk = ds^T . q, and ds carries the scale for dq = ds . k
  load_tile<T, D>(sK, L::LDB, k + koff * D, k0, BWD_BK, kv_seq, 1.f);
  load_tile<T, D>(sKs, L::LDB, k + koff * D, k0, BWD_BK, kv_seq, sm_scale);
  load_tile<T, D>(sV, L::LDB, v + koff * D, k0, BWD_BK, kv_seq, 1.f);
  for (int i = threadIdx.x; i < BWD_BK * L::LDF; i += blockDim.x) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }
  const int num_qb = cdiv(q_seq, BWD_BQ);
  const int qb_start = causal ? k0 / BWD_BQ : 0;
  // the s tile is dead once p is formed: it doubles as per-warp scratch for dq
  float* scratch = sS + warp * 256;

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
      const bool ok = qi < q_seq && ki < kv_seq && (!causal || qi >= ki);
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

    // dq += ds . k, [64 x D], added to global memory fragment by fragment
    for (int f = warp; f < 4 * NF; f += BWD_THREADS / 32) {
      const int fr = (f / NF) * 16, fc = (f % NF) * 16;
      FragC dq_acc;
      wmma::fill_fragment(dq_acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BWD_BK; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, sdS + fr * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(b, sK + kk * L::LDB + fc, L::LDB);
        wmma::mma_sync(dq_acc, a, b, dq_acc);
      }
      wmma::store_matrix_sync(scratch, dq_acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int qi = q0 + fr + e / 16;
        if (qi < q_seq) atomicAdd(dq + (qoff + qi) * D + fc + e % 16, scratch[e]);
      }
      __syncwarp();
    }
    __syncthreads();  // q/dO tiles and the scratch are reused next iteration
  }
  // a k block no query sees (causal, kv_seq > q_seq) runs no iteration: the
  // zeroed accumulators still need a barrier before other threads read them
  __syncthreads();

  for (int i = threadIdx.x; i < BWD_BK * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (k0 + r < kv_seq) {
      store8(dk + (koff + k0 + r) * D + c, sdK + r * L::LDF + c);
      store8(dv + (koff + k0 + r) * D + c, sdV + r * L::LDF + c);
    }
  }
}

// ---------------------------------------------------------------- launchers

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int q_seq, int kv_seq,
               int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = FwdSmem<D>::bytes;
  static_assert(smem <= 232448, "forward tile set exceeds the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(q_seq, FWD_BQ), bh);
  flash_fwd_kernel<T, D><<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, q_seq,
      kv_seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               float* dq, void* dk, void* dv, int bh, int q_seq, int kv_seq, int causal, float sm_scale,
               cudaStream_t stream) {
  constexpr size_t smem = BwdSmem<D>::bytes;
  static_assert(smem <= 232448, "backward tile set exceeds the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(kv_seq, BWD_BK), bh);
  flash_bwd_kernel<T, D><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
      delta, dq, static_cast<T*>(dk), static_cast<T*>(dv), q_seq, kv_seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = bfloat16, 1 = float32.
// Each returns the cudaError_t of its launch (0 on success); nothing is
// allocated and nothing synchronises.
extern "C" {

const char* mlpt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int mlpt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int q_seq, int kv_seq,
                   int head_dim, int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
#define MLPT_FWD(T, D) return launch_fwd<T, D>(q, k, v, o, lse, bh, q_seq, kv_seq, causal, sm_scale, s)
  if (dtype == 0) {
    if (head_dim == 64) MLPT_FWD(bf16, 64);
    if (head_dim == 128) MLPT_FWD(bf16, 128);
    if (head_dim == 256) MLPT_FWD(bf16, 256);
  } else if (dtype == 1) {
    if (head_dim == 64) MLPT_FWD(float, 64);
    if (head_dim == 128) MLPT_FWD(float, 128);
    if (head_dim == 256) MLPT_FWD(float, 256);
  }
#undef MLPT_FWD
  return (int)cudaErrorInvalidValue;
}

int mlpt_flash_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, float* dq, void* dk, void* dv, int bh, int q_seq, int kv_seq, int head_dim,
                   int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();
#define MLPT_BWD(T, D) \
  return launch_bwd<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, bh, q_seq, kv_seq, causal, sm_scale, s)
  if (dtype == 0) {
    if (head_dim == 64) MLPT_BWD(bf16, 64);
    if (head_dim == 128) MLPT_BWD(bf16, 128);
    if (head_dim == 256) MLPT_BWD(bf16, 256);
  } else if (dtype == 1) {
    if (head_dim == 64) MLPT_BWD(float, 64);
    if (head_dim == 128) MLPT_BWD(float, 128);
    if (head_dim == 256) MLPT_BWD(float, 256);
  }
#undef MLPT_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
