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
// for the four); A f32 [I, N]; D f32 [I]; dy, du, ddelta [B, L, I] in u's dtype
// with D (the backward's skip mode), else f32. The state checkpoint is f32 [B, ceil(L / 256), N, I]: the state entering each
// 256-step chunk, as the TPU kernel's with_checkpoints output. Both kernels
// take N = 16 states a launch, I a multiple of 8 (their tensor maps need rows
// of whole 16 bytes) and at most 65,535 batch elements (the grid's y); the
// wrapper (ops/selective_scan_fused.py) zero-pads any other d_state to a
// multiple of 16 and launches each group of 16 states, zero-pads I, and
// launches larger batches in chunks.
//
// Both kernels share one shape: a producer warp fills a ring of shared-memory
// stages by TMA through 3-D tensor maps over [B, L, I] (boxes of G steps x the
// block's channel tile) and [B, L, 16] (boxes of G rows), on full/empty
// mbarriers; consumer warps hold 4 states a thread (a channel has 4 lanes, a
// warp 8 channels: 4 independent chains a thread), with A * log2(e) in
// registers and ex2 for the decays; a storer warp takes the outputs off the
// consumers' path. Steps past L and channels past I read as zeros: an identity
// transition that adds nothing. No float atomics, so a second launch repeats
// the first bit for bit.
//
// The forward, scan_fwd_kernel. It reads u, delta, B, C and writes y and the
// checkpoint; with D given it writes y = y_scan + D * u rounded to u's dtype
// (the skip of selective_scan_pallas_fwd, :154-155, as __fmul_rn then
// __fadd_rn in f32 and one rounding: the plain version's expression), else y
// in f32 before the skip. Its bound at mamba-2.8b's [2, 4096, 5120] bf16 is
// its exps, 6.7e8 at 16 a clock on each of 132 SMs at 1.98 GHz = 0.16 ms; its
// bytes with a bf16 y (u, delta, y, the checkpoint) are about 263 MB, 0.079
// ms. It replaces a design with one state a thread (512-thread blocks of 32
// channels, 1.299 ms at that shape on an H100 SXM at 700 W, plus about 0.7
// ms of device time for the wrapper's f32 skip; PERF.md), and does about
// each of its costs:
// * y's sum over a channel's 16 states was a 16-lane shuffle tree, 4
//   shuffles a state-step. Here it is 3 multiply-adds in the thread, then a
//   reduce-scatter over the channel's 4 lanes and 4 consecutive steps: 3
//   shuffles for 4 steps, after which lane q holds y of step 4k + q.
// * Staging was synchronous: all threads copied each 64-step tile with plain
//   loads between __syncthreads. Here the producer's TMA ring keeps up to
//   FW_STAGES - 1 groups of 64 steps in flight while the consumers compute,
//   and no consumer waits at a block-wide barrier.
// * Widening bf16 to f32 took 10 of the consumers' 40 or so instructions a
//   thread-step, 8 of them for B and C, which the warp's 8 channels all
//   widen alike: a widener warp widens each group's B and C once, into one
//   of 4 f32 buffers on mbarriers (bf16 inputs; f32 ones are read as staged).
// * __expf multiplied by log2(e) each state-step; log2(e) is folded into A
//   once.
// * y went out in f32 and the wrapper added the skip and cast it in four
//   more passes (about 1.3 GB a call); here the skip and the cast are the
//   epilogue (a template argument), and y leaves in u's dtype.
// * y is staged a group at a time in shared memory (two buffers on
//   mbarriers) and the storer warp writes each group by one TMA store, whose
//   box clips steps past L and channels past I.
// * Shared memory: 3 stages of 64 steps, 4 widened B/C buffers and 2 y
//   tiles, 127,248 bytes (bf16) or 188,688 (f32, no widened buffers); the
//   registers (ptxas -v) 79-85, well under the 152 that
//   __launch_bounds__(416, 1) allows, 0 bytes of spills.
// * The grid: 80-channel tiles give mamba-2.8b's (5120 / 80, 2) = 128 blocks
//   of 13 warps, one wave on 132 SMs. The parallelism is B x I x 4 lanes,
//   1280 consumer warps at that shape, about 2.4 a sub-partition, each with 4
//   independent exp chains. The consumers issue about 35 instructions a
//   thread-step for 4 exps, so issue and the exp units share the pace, and a
//   sub-partition with 3 of a block's 10 consumer warps sets it.
// Timed against variants in one process (time_scan_variants.py, which
// rebuilds this file with constants replaced: no widener, 16- or 32-step
// groups, 2 or 8 states a thread, 40-channel tiles two blocks an SM, the
// ring's depth, y buffers; PERF.md).
//
// The backward, scan_bwd_kernel. It reads u, delta, dy, B, C and the
// checkpoint and writes du, ddelta and the dA, dB, dC partials (and with D
// the dD partials, see the last point below). Its bytes at mamba-2.8b's
// [2, 4096, 5120] bf16 are 684 MB with an f32 dy, du and ddelta (0.204 ms at
// 3.35 TB/s) and 432 MB in the skip mode (0.129 ms). The states are
// recomputed from the checkpoint in two levels, as the TPU kernel does with
// hmid: pass 1 runs a 256-step chunk forward and
// keeps each 8-step group's entry state in shared memory; pass 2 walks the
// groups backwards, recomputes the group's 8 states into registers and walks
// them back accumulating every cotangent. Each state-step thus takes 2 exps,
// one a pass (pass 2 keeps its da for the walk back): 1.34e9 exps over the
// 16 a clock of each SM's special-function units are 0.32 ms at 1.98 GHz,
// the floor of this design, above the bytes bound. Its f32 work, about 17
// operations a state-step with the sums, is about 0.4 ms more of issue.
//
// It replaces a design with one state per thread (512-thread blocks of 32
// channels, every 16-step group staged by all threads with plain loads
// between two __syncthreads, 10 shuffles a state-step, 5.485 ms at that
// shape on an H100 SXM at 700 W; about 1.48 ms now, PERF.md):
// * Asynchronous staging. A producer warp walks the block's item list (for
//   each chunk from the last: pass 1's groups forward, then pass 2's in
//   reverse) and fills a ring of STAGES shared-memory stages, 8 steps each,
//   by TMA through 3-D tensor maps over [B, L, I] (boxes of 8 steps x 80
//   channels: delta, u and in pass 2 dy) and [B, L, 16] (boxes of 8 rows: B
//   and in pass 2 C), on full/empty mbarriers. Steps past L and channels
//   past I read as zeros: an identity transition with no cotangent. No
//   consumer waits on a load that could have been issued earlier than
//   STAGES - 1 groups ahead. The tensor maps need rows of 16-byte multiples:
//   the wrapper pads I to a multiple of 8 (exact: zero channels add nothing).
// * Four states per thread. A channel has 4 lanes, each with 4 states: 4
//   independent chains a thread, 8 channels a warp, 80 channels (10
//   consumer warps), the producer warp and a storer warp a block. The sums
//   over a channel's states (ddelta, du) are 3 adds in the thread and 2
//   shuffle levels; the sums over the warp's 8 channels of dB_t[n] and
//   dC_t[n] are a reduce-scatter butterfly
//   (8 values a lane: 4 + 2 + 1 shuffles), after which each lane holds one
//   (dB or dC, state) sum and the warp writes one partial per (step, state).
// * A storer warp takes each group's outputs off the consumers' path: it
//   adds the 10 warps' partials in a fixed order into one partial per
//   80-channel tile, [n_tiles, B, L, 16], which the wrapper sums (2 x 34 MB
//   at mamba-2.8b's shape, 2 x 84 MB before), and writes du and ddelta as
//   float4 rows, from buffers the consumers fill in turns (two, on
//   mbarriers), so no consumer waits at a block-wide barrier.
// * Filling the card. mamba-2.8b's grid, (5120 / 80, 2) = 128 blocks of 12
//   warps, one an SM (hmid takes 160 KB), is one wave on 132 SMs. The
//   parallelism is B x I x 4 lanes, 10 consumer warps an SM at that shape
//   however it is tiled; 40-channel tiles, two blocks an SM, were 5% slower
//   in the same run (twice the partials; PERF.md).
// * Registers and shared memory (ptxas -v): 146 registers (bf16) and 156
//   (f32) of the 168 __launch_bounds__(384, 1) allows, 158 each in the skip
//   mode below, 0 bytes of spills; the walk back keeps the group's 8 states
//   and 8 decays for its 4 chains (64 floats). Shared memory (BwdLayout's
//   launch_bytes) 217,312 bytes (bf16, 4 stages), 212,192 in the skip mode
//   (a bf16 dy), or 212,160 (f32, 2 stages) of the 232,448 a block may use.
// * No float atomics: du and ddelta belong to one block; dA is one partial
//   per batch element ([B, N, I]) and dB, dC one per tile, all summed in a
//   fixed order, so a second run repeats the first bit for bit.
// * The D skip in its epilogue (template argument SKIP, D given). y = scan +
//   D * u adds D * dy to du and carries dD = sum dy * u. dy comes in u's
//   dtype (a bf16 dy halves the ring's dy box; the consumers widen it); the
//   lane that ends with du adds __fmul_rn(D, dy) by __fadd_rn, the f32
//   expression of the plain skip; every lane of a channel sums dy * u (each
//   product rounded, as the plain sum's terms are) over a group's 8 steps and
//   adds the group's sum to the block's by a compensated (Kahan) add, lane 0
//   writing one dD partial per batch element, [B, I]; the storer rounds du
//   and ddelta once to their dtype and writes 8-byte (bf16) or 16-byte rows.
//   Those were five f32 passes of the wrapper over [B, L, I] (about 2.5 GB a
//   call at [2, 4096, 5120]). Without D, dy, du and ddelta are f32: the
//   grouped launches of a d_state above 16 sum du and ddelta over the groups.

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NS = 16;        // d_state of one launch
constexpr int CHUNK = 256;    // checkpoint interval (the TPU kernel's block_l)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One level of a reduce-scatter across lanes `mask` apart: a lane with `bit`
// set keeps `hi` plus its partner's `hi`, the other keeps `lo` plus its
// partner's `lo`.
__device__ __forceinline__ float rs_pair(float lo, float hi, bool bit, int mask) {
  const float send = bit ? lo : hi;
  return (bit ? hi : lo) + __shfl_xor_sync(FULL, send, mask);
}

// A 3-D map over [batch, rows, inner] of `type` whose box is `box_inner` x
// `box_rows` x 1, unswizzled; coordinates past the ends read as zeros (and
// are not written by a store).
bool encode_3d(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize, int inner,
               int rows, int batch, int box_inner, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * esize, (cuuint64_t)rows * inner * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// ---------------------------------------------------------------- forward

constexpr int FW_CH = 80;                          // channels per block
constexpr int FW_SPT = 4;                          // states per thread: independent chains
constexpr int FW_LANES = NS / FW_SPT;              // lanes per channel
constexpr int FW_CPW = 32 / FW_LANES;              // channels per warp
constexpr int FW_CONSUMERS = FW_CH * FW_LANES;     // 320
constexpr int FW_NW = FW_CONSUMERS / 32;           // consumer warps
constexpr int FW_THREADS = FW_CONSUMERS + 96;      // and the producer, the storer and the widener warp
constexpr int FW_G = 64;                           // time steps per group: one ring stage, one y tile
constexpr int FW_STAGES = 3;
constexpr int FW_WIDE_BUFS = 4;                    // B and C widened to f32 (bf16 inputs)
constexpr int FW_OUT_BUFS = 2;
static_assert(FW_CONSUMERS % 32 == 0 && FW_SPT % 2 == 0, "whole warps, states in pairs");
static_assert(CHUNK % FW_G == 0 && FW_G % FW_LANES == 0, "groups tile a chunk; y's reduce-scatter tiles a group");

// Shared memory of the forward block, in bytes from a 128-byte aligned base;
// O is y's type (T with the D skip, f32 without). Barriers: full, empty
// [STAGES]; wide_full, wide_empty [WIDE_BUFS]; out_full, out_empty
// [OUT_BUFS].
template <typename T, typename O>
struct FwdLayout {
  static constexpr bool WIDEN = sizeof(T) == 2;               // a warp widens each group's B and C to f32
  static constexpr int CHAN = FW_G * FW_CH * (int)sizeof(T);  // one group of delta (or u)
  static constexpr int ST = FW_G * NS * (int)sizeof(T);       // one group of B (or C)
  static constexpr int s_delta = 0, s_u = CHAN, s_B = 2 * CHAN, s_C = 2 * CHAN + ST;
  static constexpr int STAGE = 2 * CHAN + 2 * ST;
  static constexpr int WIDE = 2 * FW_G * NS * 4;              // one group of B and C in f32
  static constexpr int OUT = FW_G * FW_CH * (int)sizeof(O);   // one group of y
  static constexpr int wide = FW_STAGES * STAGE;
  static constexpr int out = wide + (WIDEN ? FW_WIDE_BUFS * WIDE : 0);
  static constexpr int bars = out + FW_OUT_BUFS * OUT;
  static constexpr int launch_bytes = bars + 16 * (FW_STAGES + FW_WIDE_BUFS + FW_OUT_BUFS) + 128;
  static_assert(CHAN % 128 == 0 && ST % 128 == 0 && OUT % 128 == 0, "TMA boxes stay 128-byte aligned");
};

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A thread's SPT consecutive states of B (or C) at one step, as f32.
template <int SPT, typename BT>
__device__ __forceinline__ void load_states(float (&v)[SPT], const BT* p) {
  if constexpr (SPT % 4 == 0) {
#pragma unroll
    for (int k = 0; k < SPT; k += 4) {
      const float4 f = load4(p + k);
      v[k] = f.x, v[k + 1] = f.y, v[k + 2] = f.z, v[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SPT; k += 2) {
      const float2 f = load2(p + k);
      v[k] = f.x, v[k + 1] = f.y;
    }
  }
}

// Sum each of N values over the N lanes (1, 2, 4 ... apart) that share them:
// a reduce-scatter, after which lane q (of the N) holds the sum of p[q].
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&p)[N], int q) {
#pragma unroll
  for (int m = N / 2; m >= 1; m /= 2) {
#pragma unroll
    for (int k = 0; k < m; ++k) p[k] = rs_pair(p[k], p[k + m], q & m, m);
  }
  return p[0];
}

__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Four consecutive values to global memory in p's type, each rounded once.
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <typename T, bool SKIP>
__global__ void __launch_bounds__(FW_THREADS, 1)
    scan_fwd_kernel(const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_delta,
                    const __grid_constant__ CUtensorMap tm_B, const __grid_constant__ CUtensorMap tm_C,
                    const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ A,
                    const float* __restrict__ D, float* __restrict__ ckpt, int L, int I) {
  using O = std::conditional_t<SKIP, T, float>;
  using S = FwdLayout<T, O>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + S::bars, bar_empty = bar_full + 8 * FW_STAGES;
  const uint32_t bar_wide_full = bar_empty + 8 * FW_STAGES, bar_wide_empty = bar_wide_full + 8 * FW_WIDE_BUFS;
  const uint32_t bar_out_full = bar_wide_empty + 8 * FW_WIDE_BUFS, bar_out_empty = bar_out_full + 8 * FW_OUT_BUFS;

  const int b = blockIdx.y, i0 = blockIdx.x * FW_CH;
  const int n_groups = cdiv(L, FW_G), n_chunks = cdiv(L, CHUNK);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, FW_NW + S::WIDEN);  // every consumer warp, and the widener
    }
#pragma unroll
    for (int k = 0; k < FW_WIDE_BUFS; ++k) {
      mbar_init(bar_wide_full + 8 * k, 1);
      mbar_init(bar_wide_empty + 8 * k, FW_NW);
    }
#pragma unroll
    for (int k = 0; k < FW_OUT_BUFS; ++k) {
      mbar_init(bar_out_full + 8 * k, FW_NW);
      mbar_init(bar_out_empty + 8 * k, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == FW_NW + 2) {
    // ---- widener (bf16): each group's B and C to f32, once for all the block's channels
    if constexpr (S::WIDEN) {
      for (int j = 0; j < n_groups; ++j) {
        const int s = j % FW_STAGES, w = j % FW_WIDE_BUFS;
        if (j >= FW_WIDE_BUFS) mbar_wait(bar_wide_empty + 8 * w, (j / FW_WIDE_BUFS - 1) & 1);
        mbar_wait(bar_full + 8 * s, (j / FW_STAGES) & 1);
        const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(smem + s * S::STAGE + S::s_B);
        float2* dst = reinterpret_cast<float2*>(smem + S::wide + w * S::WIDE);
#pragma unroll
        for (int r = 0; r < 2 * FW_G * NS / 2 / 32; ++r) dst[lane + 32 * r] = __bfloat1622float2(src[lane + 32 * r]);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(bar_empty + 8 * s);
          mbar_arrive(bar_wide_full + 8 * w);
        }
      }
    }
    return;
  }
  if (warp == FW_NW + 1) {
    // ---- storer: one thread writes each group's y tile by TMA as the consumers finish it
    if (lane == 0) {
      prefetch_tensormap(&tm_y);
      for (int j = 0; j < n_groups; ++j) {
        const int buf = j % FW_OUT_BUFS;
        mbar_wait(bar_out_full + 8 * buf, (j / FW_OUT_BUFS) & 1);
        tma_store_3d(&tm_y, base + S::out + buf * S::OUT, i0, j * FW_G, b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(bar_out_empty + 8 * buf);
      }
      bulk_wait();
    }
    return;
  }
  if (warp == FW_NW) {
    // ---- producer: one thread fills the ring, group by group
    if (lane == 0) {
      prefetch_tensormap(&tm_u);
      prefetch_tensormap(&tm_delta);
      prefetch_tensormap(&tm_B);
      prefetch_tensormap(&tm_C);
      for (int j = 0; j < n_groups; ++j) {
        const int s = j % FW_STAGES, t0 = j * FW_G;
        if (j >= FW_STAGES) mbar_wait(bar_empty + 8 * s, (j / FW_STAGES - 1) & 1);
        const uint32_t st = base + s * S::STAGE, full = bar_full + 8 * s;
        mbar_expect_tx(full, S::STAGE);
        tma_load_3d(st + S::s_delta, &tm_delta, i0, t0, b, full);
        tma_load_3d(st + S::s_u, &tm_u, i0, t0, b, full);
        tma_load_3d(st + S::s_B, &tm_B, 0, t0, b, full);
        tma_load_3d(st + S::s_C, &tm_C, 0, t0, b, full);
      }
    }
    return;
  }

  // ---- consumers: lane q of channel c holds states q * SPT .. q * SPT + SPT - 1
  const int cw = lane / FW_LANES, q = lane % FW_LANES;
  const int c = warp * FW_CPW + cw, i = i0 + c;
  const bool active = i < I;
  float a2[FW_SPT], h[FW_SPT];  // A * log2(e), the state
#pragma unroll
  for (int j = 0; j < FW_SPT; ++j) {
    a2[j] = active ? A[(size_t)i * NS + q * FW_SPT + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }
  const float d_skip = SKIP && active ? D[i] : 0.f;
  float* ck = ckpt + ((size_t)b * n_chunks * NS + q * FW_SPT) * I + i;  // chunk k, state j: [(k*NS + j)*I]

  for (int j = 0; j < n_groups; ++j) {
    const int s = j % FW_STAGES, w = j % FW_WIDE_BUFS, buf = j % FW_OUT_BUFS, t0 = j * FW_G;
    if (t0 % CHUNK == 0 && active) {
#pragma unroll
      for (int jj = 0; jj < FW_SPT; ++jj) ck[((size_t)(t0 / CHUNK) * NS + jj) * I] = h[jj];  // entering the chunk
    }
    const unsigned char* st = smem + s * S::STAGE;
    const T* s_delta = reinterpret_cast<const T*>(st + S::s_delta);
    const T* s_u = reinterpret_cast<const T*>(st + S::s_u);
    // B and C: widened to f32 by the widener warp, or as staged
    using BT = std::conditional_t<S::WIDEN, float, T>;
    const BT* s_B = reinterpret_cast<const BT*>(S::WIDEN ? smem + S::wide + w * S::WIDE : st + S::s_B);
    const BT* s_C = s_B + FW_G * NS;
    s_B += q * FW_SPT, s_C += q * FW_SPT;
    O* s_y = reinterpret_cast<O*>(smem + S::out + buf * S::OUT);
    if (j >= FW_OUT_BUFS) mbar_wait(bar_out_empty + 8 * buf, (j / FW_OUT_BUFS - 1) & 1);  // the storer has read it
    mbar_wait(bar_full + 8 * s, (j / FW_STAGES) & 1);
    if constexpr (S::WIDEN) mbar_wait(bar_wide_full + 8 * w, (j / FW_WIDE_BUFS) & 1);

#pragma unroll
    for (int k = 0; k < FW_G / FW_LANES; ++k) {
      float p[FW_LANES];  // this thread's part of y at steps LANES k .. LANES k + LANES - 1
#pragma unroll
      for (int tt = 0; tt < FW_LANES; ++tt) {
        const int t = k * FW_LANES + tt;
        const float d = to_f(s_delta[t * FW_CH + c]), du_ = d * to_f(s_u[t * FW_CH + c]);
        float Bn[FW_SPT], Cn[FW_SPT];
        load_states(Bn, s_B + t * NS);
        load_states(Cn, s_C + t * NS);
#pragma unroll
        for (int jj = 0; jj < FW_SPT; ++jj) h[jj] = fmaf(ex2(d * a2[jj]), h[jj], du_ * Bn[jj]);
        float acc = Cn[0] * h[0];
#pragma unroll
        for (int jj = 1; jj < FW_SPT; ++jj) acc = fmaf(Cn[jj], h[jj], acc);
        p[tt] = acc;
      }
      const int t = k * FW_LANES + q;  // the step whose y this lane ends with
      float yv = reduce_scatter(p, q);
      if constexpr (SKIP) yv = __fadd_rn(yv, __fmul_rn(d_skip, to_f(s_u[t * FW_CH + c])));
      store_y(s_y + t * FW_CH + c, yv);
    }
    fence_proxy_async();  // y's tile becomes visible to the TMA store
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bar_empty + 8 * s);
      if constexpr (S::WIDEN) mbar_arrive(bar_wide_empty + 8 * w);
      mbar_arrive(bar_out_full + 8 * buf);
    }
  }
}

template <typename T, bool SKIP>
int launch_fwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, const float* D,
               void* y, float* ckpt, int batch, int L, int I, cudaStream_t stream) {
  using O = std::conditional_t<SKIP, T, float>;
  using S = FwdLayout<T, O>;
  static_assert(S::launch_bytes <= 232448, "the forward's shared memory exceeds the 227 KB a block may use");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int es = (int)sizeof(T);
  CUtensorMap tu, td, tB, tC, ty;
  if (!encode_3d(fn, &tu, u, tma_type<T>(), es, I, L, batch, FW_CH, FW_G) ||
      !encode_3d(fn, &td, delta, tma_type<T>(), es, I, L, batch, FW_CH, FW_G) ||
      !encode_3d(fn, &tB, Bm, tma_type<T>(), es, NS, L, batch, NS, FW_G) ||
      !encode_3d(fn, &tC, Cm, tma_type<T>(), es, NS, L, batch, NS, FW_G) ||
      !encode_3d(fn, &ty, y, tma_type<O>(), (int)sizeof(O), I, L, batch, FW_CH, FW_G))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(scan_fwd_kernel<T, SKIP>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::launch_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(I, FW_CH), batch);
  scan_fwd_kernel<T, SKIP><<<grid, FW_THREADS, S::launch_bytes, stream>>>(tu, td, tB, tC, ty, A, D, ckpt, L, I);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward

constexpr int BW_CH = 80;                          // channels per block
constexpr int BW_LANES = 4;                        // lanes per channel
constexpr int BW_SPT = NS / BW_LANES;              // states per thread: independent chains
constexpr int BW_CPW = 32 / BW_LANES;              // channels per warp
constexpr int BW_CONSUMERS = BW_CH * BW_LANES;     // 320
constexpr int BW_NW = BW_CONSUMERS / 32;           // consumer warps
constexpr int BW_THREADS = BW_CONSUMERS + 64;      // and the producer and the storer warp
constexpr int BW_G = 8;                            // time steps per group (one ring stage)
constexpr int BW_GROUPS = CHUNK / BW_G;
static_assert(BW_CONSUMERS % 32 == 0 && BW_SPT == 4, "whole warps, 4 states a thread");
static_assert(2 * BW_G * BW_CH % (4 * BW_CONSUMERS) == 0 && BW_CH % 8 == 0, "whole float4s of du, ddelta a thread");

// Shared memory of the backward block, in bytes from a 128-byte aligned base;
// DYT is dy's type (T with the D skip, f32 without).
template <typename T, bool SKIP>
struct BwdLayout {
  using DYT = std::conditional_t<SKIP, T, float>;
  static constexpr int STAGES = sizeof(T) == 2 ? 4 : 2;
  static constexpr int CHAN = BW_G * BW_CH * (int)sizeof(T);  // one group of delta (or u)
  static constexpr int DY = BW_G * BW_CH * (int)sizeof(DYT);  // one group of dy
  static constexpr int ST = BW_G * NS * (int)sizeof(T);       // one group of B (or C)
  static constexpr int s_delta = 0, s_u = CHAN, s_dy = 2 * CHAN, s_B = s_dy + DY, s_C = s_B + ST;
  static constexpr int STAGE = s_C + ST;
  static constexpr int hmid = STAGES * STAGE;                          // [BW_GROUPS][BW_CONSUMERS] float4
  static constexpr int part = hmid + BW_GROUPS * BW_CONSUMERS * 16;    // [2][BW_NW][BW_G][32]: dB, dC by warp
  static constexpr int out = part + 2 * BW_NW * BW_G * 32 * 4;         // [2][2][BW_G][BW_CH]: ddelta, du
  static constexpr int bars = out + 2 * 2 * BW_G * BW_CH * 4;         // full, empty [STAGES]; out_full, out_empty [2]
  static constexpr int launch_bytes = bars + 16 * STAGES + 32 + 128;   // + out_full[2], out_empty[2]; align
  static_assert(CHAN % 128 == 0 && DY % 128 == 0 && ST % 128 == 0, "TMA destinations stay 128-byte aligned");
};

// Item j of a block's walk, the same for producer and consumers: the chunks
// from the last to the first; in each (ng groups), pass 1 over groups 0 ..
// ng - 2 (the last group's entry state is all it must reach), then pass 2
// over groups ng - 1 .. 0.
struct Item {
  int k, g, pass2;
};

__device__ __forceinline__ Item item_at(int j, int n_chunks, int last_groups) {
  int k = n_chunks - 1, ng = last_groups, local = j;
  if (j >= 2 * last_groups - 1) {
    const int r = j - (2 * last_groups - 1);
    k = n_chunks - 2 - r / (2 * BW_GROUPS - 1);
    local = r % (2 * BW_GROUPS - 1);
    ng = BW_GROUPS;
  }
  return local < ng - 1 ? Item{k, local, 0} : Item{k, 2 * ng - 2 - local, 1};
}


template <typename T, bool SKIP>
__global__ void __launch_bounds__(BW_THREADS, 1)
    scan_bwd_kernel(const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_delta,
                    const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_B,
                    const __grid_constant__ CUtensorMap tm_C, const float* __restrict__ A,
                    const float* __restrict__ D, const float* __restrict__ ckpt,
                    std::conditional_t<SKIP, T, float>* __restrict__ du,
                    std::conditional_t<SKIP, T, float>* __restrict__ ddelta, float* __restrict__ dA_part,
                    float* __restrict__ dB_part, float* __restrict__ dC_part, float* __restrict__ dD_part,
                    int batch, int L, int I) {
  using S = BwdLayout<T, SKIP>;
  using DYT = typename S::DYT;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + S::bars, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_out_full = bar_empty + 8 * STAGES, bar_out_empty = bar_out_full + 16;

  const int b = blockIdx.y, tile = blockIdx.x, i0 = tile * BW_CH;
  const int n_chunks = cdiv(L, CHUNK);
  const int last_groups = cdiv(L - (n_chunks - 1) * CHUNK, BW_G);
  const int n_items = 2 * ((n_chunks - 1) * BW_GROUPS + last_groups) - n_chunks;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, BW_NW);  // every consumer warp
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mbar_init(bar_out_full + 8 * k, BW_NW);
      mbar_init(bar_out_empty + 8 * k, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == BW_NW + 1) {
    // ---- storer warp: each pass-2 group's outputs, as the consumers finish it
    int p = 0;
    for (int j = 0; j < n_items; ++j) {
      const Item it = item_at(j, n_chunks, last_groups);
      if (!it.pass2) continue;
      const int buf = p & 1;
      mbar_wait(bar_out_full + 8 * buf, (p >> 1) & 1);
      const int t0 = it.k * CHUNK + it.g * BW_G;
      const float* outs = reinterpret_cast<const float*>(smem + S::out) + buf * 2 * BW_G * BW_CH;
#pragma unroll
      for (int r = 0; r < 2 * BW_G * BW_CH / 4 / 32; ++r) {
        const int e = lane + r * 32;
        const int which = e / (BW_G * BW_CH / 4), t = (e / (BW_CH / 4)) % BW_G, cc = 4 * (e % (BW_CH / 4));
        if (t0 + t < L && i0 + cc < I)
          store4((which ? du : ddelta) + ((size_t)b * L + t0 + t) * I + i0 + cc,
                 *reinterpret_cast<const float4*>(outs + 4 * e));
      }
#pragma unroll
      for (int r = 0; r < BW_G * NS / 32; ++r) {
        const int e = lane + r * 32, t = e / NS, v = 2 * (e % NS);
        if (t0 + t < L) {
          const float* parts = reinterpret_cast<const float*>(smem + S::part) + buf * BW_NW * BW_G * 32 + t * 32 + v;
          float2 acc = *reinterpret_cast<const float2*>(parts);
#pragma unroll
          for (int w = 1; w < BW_NW; ++w) {
            const float2 q2 = *reinterpret_cast<const float2*>(parts + w * BW_G * 32);
            acc.x += q2.x;
            acc.y += q2.y;
          }
          *reinterpret_cast<float2*>((v < NS ? dB_part : dC_part) + (((size_t)tile * batch + b) * L + t0 + t) * NS +
                                     v % NS) = acc;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_out_empty + 8 * buf);
      ++p;
    }
    return;
  }
  if (warp == BW_NW) {
    // ---- producer: one thread fills the ring, item by item
    if (lane == 0) {
      prefetch_tensormap(&tm_u);
      prefetch_tensormap(&tm_delta);
      prefetch_tensormap(&tm_dy);
      prefetch_tensormap(&tm_B);
      prefetch_tensormap(&tm_C);
      for (int j = 0; j < n_items; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, (j / STAGES - 1) & 1);
        const Item it = item_at(j, n_chunks, last_groups);
        const int t0 = it.k * CHUNK + it.g * BW_G;
        const uint32_t st = base + s * S::STAGE, full = bar_full + 8 * s;
        mbar_expect_tx(full, it.pass2 ? 2 * S::CHAN + S::DY + 2 * S::ST : 2 * S::CHAN + S::ST);
        tma_load_3d(st + S::s_delta, &tm_delta, i0, t0, b, full);
        tma_load_3d(st + S::s_u, &tm_u, i0, t0, b, full);
        tma_load_3d(st + S::s_B, &tm_B, 0, t0, b, full);
        if (it.pass2) {
          tma_load_3d(st + S::s_dy, &tm_dy, i0, t0, b, full);
          tma_load_3d(st + S::s_C, &tm_C, 0, t0, b, full);
        }
      }
    }
    return;
  }

  // ---- consumers: lane q of channel c holds states 4q .. 4q + 3
  const int tid = threadIdx.x, cw = lane / BW_LANES, q = lane % BW_LANES;
  const int c = warp * BW_CPW + cw, i = i0 + c;
  const bool active = i < I;
  float a[BW_SPT], a2[BW_SPT];  // A and A * log2(e)
#pragma unroll
  for (int j = 0; j < BW_SPT; ++j) {
    a[j] = active ? A[(size_t)i * NS + q * BW_SPT + j] : 0.f;
    a2[j] = a[j] * LOG2E;
  }
  const float* ck = ckpt + ((size_t)b * n_chunks * NS + q * BW_SPT) * I + i;  // chunk k, state j: [(k*NS + j)*I]
  float G[BW_SPT], dA_acc[BW_SPT], h[BW_SPT], h0[BW_SPT], h0_next[BW_SPT];
  const float d_skip = SKIP && active ? D[i] : 0.f;
  float dD_sum = 0.f, dD_comp = 0.f;  // dD over the block's steps, and its compensation
#pragma unroll
  for (int j = 0; j < BW_SPT; ++j) {
    G[j] = dA_acc[j] = 0.f;  // G = da_{t+1} gh_{t+1}, the reverse carry
    h0_next[j] = active ? ck[((size_t)(n_chunks - 1) * NS + j) * I] : 0.f;
  }
  float4* hmid = reinterpret_cast<float4*>(smem + S::hmid);
  int chunk = -1, n_pass2 = 0;

  for (int j = 0; j < n_items; ++j) {
    const Item it = item_at(j, n_chunks, last_groups);
    if (it.k != chunk) {
      // the chunk's entry state, loaded one chunk ahead
      chunk = it.k;
#pragma unroll
      for (int jj = 0; jj < BW_SPT; ++jj) {
        h0[jj] = h[jj] = h0_next[jj];
        if (chunk > 0) h0_next[jj] = active ? ck[((size_t)(chunk - 1) * NS + jj) * I] : 0.f;
      }
    }
    const int s = j % STAGES;
    const unsigned char* st = smem + s * S::STAGE;
    const T* s_delta = reinterpret_cast<const T*>(st + S::s_delta);
    const T* s_u = reinterpret_cast<const T*>(st + S::s_u);
    const DYT* s_dy = reinterpret_cast<const DYT*>(st + S::s_dy);
    const T* s_B = reinterpret_cast<const T*>(st + S::s_B) + q * BW_SPT;
    const T* s_C = reinterpret_cast<const T*>(st + S::s_C) + q * BW_SPT;
    mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);

    if (!it.pass2) {
      // pass 1: advance the state through group g and keep group g + 1's entry
#pragma unroll
      for (int t = 0; t < BW_G; ++t) {
        const float d = to_f(s_delta[t * BW_CH + c]), du_ = d * to_f(s_u[t * BW_CH + c]);
        const float4 Bv = load4(s_B + t * NS);
        const float Bn[4] = {Bv.x, Bv.y, Bv.z, Bv.w};
#pragma unroll
        for (int jj = 0; jj < BW_SPT; ++jj) h[jj] = fmaf(ex2(d * a2[jj]), h[jj], du_ * Bn[jj]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      hmid[(it.g + 1) * BW_CONSUMERS + tid] = make_float4(h[0], h[1], h[2], h[3]);
      continue;
    }

    // pass 2: recompute the group's states and decays, then walk them back
    float he[BW_SPT];
    if (it.g == 0) {
#pragma unroll
      for (int jj = 0; jj < BW_SPT; ++jj) he[jj] = h0[jj];
    } else {
      const float4 v = hmid[it.g * BW_CONSUMERS + tid];
      he[0] = v.x, he[1] = v.y, he[2] = v.z, he[3] = v.w;
    }
    float das[BW_G][BW_SPT], hs[BW_G][BW_SPT];
#pragma unroll
    for (int t = 0; t < BW_G; ++t) {
      const float d = to_f(s_delta[t * BW_CH + c]), du_ = d * to_f(s_u[t * BW_CH + c]);
      const float4 Bv = load4(s_B + t * NS);
      const float Bn[4] = {Bv.x, Bv.y, Bv.z, Bv.w};
#pragma unroll
      for (int jj = 0; jj < BW_SPT; ++jj) {
        das[t][jj] = ex2(d * a2[jj]);
        hs[t][jj] = fmaf(das[t][jj], t > 0 ? hs[t > 0 ? t - 1 : 0][jj] : he[jj], du_ * Bn[jj]);
      }
    }
    const int p2 = n_pass2++, buf = p2 & 1;
    if (p2 >= 2) mbar_wait(bar_out_empty + 8 * buf, ((p2 >> 1) - 1) & 1);  // the storer is done with it
    float* s_part = reinterpret_cast<float*>(smem + S::part) + (buf * BW_NW + warp) * BW_G * 32;
    float* s_out = reinterpret_cast<float*>(smem + S::out) + buf * 2 * BW_G * BW_CH;
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    float dD_group = 0.f;
#pragma unroll
    for (int t = BW_G - 1; t >= 0; --t) {
      const float d = to_f(s_delta[t * BW_CH + c]), uu = to_f(s_u[t * BW_CH + c]), gy = to_f(s_dy[t * BW_CH + c]);
      const float du_ = d * uu;
      const float4 Bv = load4(s_B + t * NS), Cv = load4(s_C + t * NS);
      const float Bn[4] = {Bv.x, Bv.y, Bv.z, Bv.w}, Cn[4] = {Cv.x, Cv.y, Cv.z, Cv.w};
      float sa = 0.f, sb = 0.f, pb[BW_SPT], pc[BW_SPT];
#pragma unroll
      for (int jj = 0; jj < BW_SPT; ++jj) {
        const float gh = fmaf(Cn[jj], gy, G[jj]);
        const float h_prev = t > 0 ? hs[t > 0 ? t - 1 : 0][jj] : he[jj];
        const float common = gh * h_prev * das[t][jj];
        dA_acc[jj] = fmaf(common, d, dA_acc[jj]);
        sa = fmaf(common, a[jj], sa);
        sb = fmaf(gh, Bn[jj], sb);
        pb[jj] = gh * du_;  // dB_t[n] term: gh * delta * u
        pc[jj] = hs[t][jj] * gy;  // dC_t[n] term: h_t * dy
        G[jj] = das[t][jj] * gh;
      }
      // ddelta = sum_n gh A h_prev da + (sum_n gh B) u and du = (sum_n gh B)
      // delta over the channel's 4 lanes: even lanes end with ddelta, odd with du
      float r = rs_pair(fmaf(sb, uu, sa), sb * d, q & 1, 1);
      r += __shfl_xor_sync(FULL, r, 2);
      if constexpr (SKIP) {
        if (q == 1) r = __fadd_rn(r, __fmul_rn(d_skip, gy));  // du + D * dy
        dD_group = __fadd_rn(dD_group, __fmul_rn(gy, uu));
      }
      if (q < 2) s_out[(q * BW_G + t) * BW_CH + c] = r;
      // dB and dC over the warp's 8 channels: the lane keeps (dB if !b4 else
      // dC) of state 4q + (cw & 3)
      float w[4], x[2];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = rs_pair(pb[k], pc[k], b4, 16);
#pragma unroll
      for (int k = 0; k < 2; ++k) x[k] = rs_pair(w[k], w[k + 2], b3, 8);
      s_part[t * 32 + (b4 ? NS : 0) + q * BW_SPT + (cw & 3)] = rs_pair(x[0], x[1], b2, 4);
    }
    if constexpr (SKIP) {  // the group's dD into the block's, compensated
      const float y = __fsub_rn(dD_group, dD_comp), sum = __fadd_rn(dD_sum, y);
      dD_comp = __fsub_rn(__fsub_rn(sum, dD_sum), y);
      dD_sum = sum;
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bar_empty + 8 * s);
      mbar_arrive(bar_out_full + 8 * buf);
    }
  }
  if (active) {
#pragma unroll
    for (int jj = 0; jj < BW_SPT; ++jj) dA_part[((size_t)b * NS + q * BW_SPT + jj) * I + i] = dA_acc[jj];
    if (SKIP && q == 0) dD_part[(size_t)b * I + i] = dD_sum;
  }
}

template <typename T, bool SKIP>
int launch_bwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, const float* D,
               const void* dy, const float* ckpt, void* du, void* ddelta, float* dA_part, float* dB_part,
               float* dC_part, float* dD_part, int batch, int L, int I, cudaStream_t stream) {
  using S = BwdLayout<T, SKIP>;
  using O = std::conditional_t<SKIP, T, float>;
  static_assert(S::launch_bytes <= 232448, "the backward's shared memory exceeds the 227 KB a block may use");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType ty = tma_type<T>();
  const int es = (int)sizeof(T);
  CUtensorMap tu, td, tdy, tB, tC;
  if (!encode_3d(fn, &tu, u, ty, es, I, L, batch, BW_CH, BW_G) ||
      !encode_3d(fn, &td, delta, ty, es, I, L, batch, BW_CH, BW_G) ||
      !encode_3d(fn, &tdy, dy, tma_type<typename S::DYT>(), (int)sizeof(typename S::DYT), I, L, batch, BW_CH, BW_G) ||
      !encode_3d(fn, &tB, Bm, ty, es, NS, L, batch, NS, BW_G) || !encode_3d(fn, &tC, Cm, ty, es, NS, L, batch, NS, BW_G))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(scan_bwd_kernel<T, SKIP>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::launch_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(I, BW_CH), batch);
  scan_bwd_kernel<T, SKIP><<<grid, BW_THREADS, S::launch_bytes, stream>>>(
      tu, td, tdy, tB, tC, A, D, ckpt, static_cast<O*>(du), static_cast<O*>(ddelta), dA_part, dB_part, dC_part,
      dD_part, batch, L, I);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C entry points
// dtype: 0 = bf16, 1 = f32 (u, delta, B and C). N must be 16 (the wrapper
// launches each group of 16 states), I a multiple of 8 (the tensor maps' row
// pitch) and batch at most 65,535 (the grid's y; the wrapper launches larger
// batches in chunks). All pointers 16-byte aligned and contiguous. The
// forward takes a nullable D: given, y is y_scan + D * u in u's dtype, else
// f32 y before the skip. The backward writes dB and dC as one partial per
// 80-channel tile, [ceil(I / 80), B, L, 16], and dA as one per batch element,
// [B, 16, I]. It takes a nullable D too: given, dy, du and ddelta are in u's
// dtype, du holds the skip's D * dy, and dD is written as one partial per
// batch element, [B, I]; without, dy, du and ddelta are f32 of y before the
// skip and dD_part is not read. Return a cudaError_t code, 0 on success.

extern "C" {

int mlpt_scan_fwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, const float* D,
                  void* y, float* ckpt, int batch, int L, int I, int N, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  if (N != NS || batch <= 0 || L <= 0 || I <= 0 || I % 8 != 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D != nullptr ? launch_fwd<bf16, true>(u, delta, A, Bm, Cm, D, y, ckpt, batch, L, I, s)
                        : launch_fwd<bf16, false>(u, delta, A, Bm, Cm, D, y, ckpt, batch, L, I, s);
  if (dtype == 1)
    return D != nullptr ? launch_fwd<float, true>(u, delta, A, Bm, Cm, D, y, ckpt, batch, L, I, s)
                        : launch_fwd<float, false>(u, delta, A, Bm, Cm, D, y, ckpt, batch, L, I, s);
  return (int)cudaErrorInvalidValue;
}

int mlpt_scan_bwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, const float* D,
                  const void* dy, const float* ckpt, void* du, void* ddelta, float* dA_part, float* dB_part,
                  float* dC_part, float* dD_part, int batch, int L, int I, int N, int dtype, void* stream) {
  (void)cudaGetLastError();
  if (N != NS || batch <= 0 || L <= 0 || I <= 0 || I % 8 != 0 || batch > 65535 || (D != nullptr && dD_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D != nullptr ? launch_bwd<bf16, true>(u, delta, A, Bm, Cm, D, dy, ckpt, du, ddelta, dA_part, dB_part,
                                                 dC_part, dD_part, batch, L, I, s)
                        : launch_bwd<bf16, false>(u, delta, A, Bm, Cm, D, dy, ckpt, du, ddelta, dA_part, dB_part,
                                                  dC_part, dD_part, batch, L, I, s);
  if (dtype == 1)
    return D != nullptr ? launch_bwd<float, true>(u, delta, A, Bm, Cm, D, dy, ckpt, du, ddelta, dA_part, dB_part,
                                                  dC_part, dD_part, batch, L, I, s)
                        : launch_bwd<float, false>(u, delta, A, Bm, Cm, D, dy, ckpt, du, ddelta, dA_part, dB_part,
                                                   dC_part, dD_part, batch, L, I, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
