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
// chunk, as the TPU kernel's with_checkpoints output. Both kernels take N = 16
// states a launch; the wrapper (ops/selective_scan_fused.py) zero-pads any
// other d_state to a multiple of 16 and launches each group of 16 states.
//
// The forward, scan_fwd_kernel:
// * The sequential carry. The TPU grid (batch, I-block, L-chunk) runs in order,
//   so the state h lives in VMEM scratch and carries from chunk to chunk. GPU
//   blocks run in parallel and in no order, so the whole L loop lives inside
//   one block per (batch, 32 channels), and the carry inside each thread's
//   registers. Each channel gets 16 lanes, one per state n: half a warp per
//   channel, 512 threads per block. y_t is a 16-lane shuffle reduction.
// * Memory traffic. Materialising the discretized [L, I, N] tensors would cost
//   O(L * I * N) bytes of device memory; here they exist only in registers, so
//   traffic stays O(L * I). Inputs stage through shared memory one tile of
//   64 time steps at a time, loaded coalesced across channels.
//
// The backward, scan_bwd_kernel. It reads u, delta, dy, B, C and the
// checkpoint and writes du, ddelta and the dA, dB, dC partials; its bound at
// mamba-2.8b's [2, 4096, 5120] bf16 is its bytes, 684 MB over 3.35 TB/s =
// 0.204 ms. The states are recomputed from the checkpoint in two levels, as
// the TPU kernel does with hmid: pass 1 runs a 256-step chunk forward and
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
//   (f32) of the 168 __launch_bounds__(384, 1) allows, 0 bytes of spills;
//   the walk back keeps the group's 8 states and 8 decays for its 4 chains
//   (64 floats). Shared memory 227,552 bytes (bf16, 4 stages) or 222,400
//   (f32, 2 stages) of the 232,448 a block may use.
// * No float atomics: du and ddelta belong to one block; dA is one partial
//   per batch element ([B, N, I]) and dB, dC one per tile, all summed in a
//   fixed order, so a second run repeats the first bit for bit.

#include "hopper.cuh"

namespace {

constexpr int NS = 16;             // d_state of one launch
constexpr int CH = 32;             // forward: channels per block, one lane per state
constexpr int THREADS = CH * NS;   // 512
constexpr int CHUNK = 256;         // checkpoint interval (the TPU kernel's block_l)
constexpr int FWD_TILE = 64;       // forward: time steps staged per tile
constexpr unsigned FULL = 0xffffffffu;

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

// Shared memory of the backward block, in bytes from a 128-byte aligned base.
template <typename T>
struct BwdLayout {
  static constexpr int STAGES = sizeof(T) == 2 ? 4 : 2;
  static constexpr int CHAN = BW_G * BW_CH * (int)sizeof(T);  // one group of delta (or u)
  static constexpr int DY = BW_G * BW_CH * 4;                 // one group of dy (f32)
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

template <typename T>
__global__ void __launch_bounds__(BW_THREADS, 1)
    scan_bwd_kernel(const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_delta,
                    const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_B,
                    const __grid_constant__ CUtensorMap tm_C, const float* __restrict__ A,
                    const float* __restrict__ ckpt, float* __restrict__ du, float* __restrict__ ddelta,
                    float* __restrict__ dA_part, float* __restrict__ dB_part, float* __restrict__ dC_part,
                    int batch, int L, int I) {
  using S = BwdLayout<T>;
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
          *reinterpret_cast<float4*>((which ? du : ddelta) + ((size_t)b * L + t0 + t) * I + i0 + cc) =
              *reinterpret_cast<const float4*>(outs + 4 * e);
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
    const float* s_dy = reinterpret_cast<const float*>(st + S::s_dy);
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
#pragma unroll
    for (int t = BW_G - 1; t >= 0; --t) {
      const float d = to_f(s_delta[t * BW_CH + c]), uu = to_f(s_u[t * BW_CH + c]), gy = s_dy[t * BW_CH + c];
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
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bar_empty + 8 * s);
      mbar_arrive(bar_out_full + 8 * buf);
    }
  }
  if (active) {
#pragma unroll
    for (int jj = 0; jj < BW_SPT; ++jj) dA_part[((size_t)b * NS + q * BW_SPT + jj) * I + i] = dA_acc[jj];
  }
}

template <typename T>
int launch_fwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, float* y, float* ckpt,
               int batch, int L, int I, cudaStream_t stream) {
  dim3 grid(cdiv(I, CH), batch);
  scan_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(u), static_cast<const T*>(delta), A,
                                                    static_cast<const T*>(Bm), static_cast<const T*>(Cm), y, ckpt, L, I);
  return (int)cudaGetLastError();
}

// A 3-D map over [batch, rows, inner] of `type` whose box is `box_inner` x
// `box_rows` x 1, unswizzled; coordinates past the ends read as zeros.
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
int launch_bwd(const void* u, const void* delta, const float* A, const void* Bm, const void* Cm, const float* dy,
               const float* ckpt, float* du, float* ddelta, float* dA_part, float* dB_part, float* dC_part, int batch,
               int L, int I, cudaStream_t stream) {
  using S = BwdLayout<T>;
  static_assert(S::launch_bytes <= 232448, "the backward's shared memory exceeds the 227 KB a block may use");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType ty = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int es = (int)sizeof(T);
  CUtensorMap tu, td, tdy, tB, tC;
  if (!encode_3d(fn, &tu, u, ty, es, I, L, batch, BW_CH, BW_G) ||
      !encode_3d(fn, &td, delta, ty, es, I, L, batch, BW_CH, BW_G) ||
      !encode_3d(fn, &tdy, dy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, I, L, batch, BW_CH, BW_G) ||
      !encode_3d(fn, &tB, Bm, ty, es, NS, L, batch, NS, BW_G) || !encode_3d(fn, &tC, Cm, ty, es, NS, L, batch, NS, BW_G))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::launch_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(I, BW_CH), batch);
  scan_bwd_kernel<T><<<grid, BW_THREADS, S::launch_bytes, stream>>>(tu, td, tdy, tB, tC, A, ckpt, du, ddelta, dA_part,
                                                                     dB_part, dC_part, batch, L, I);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C entry points
// dtype: 0 = bf16, 1 = f32 (u, delta, B and C). N must be 16 (the wrapper
// launches each group of 16 states). All pointers 16-byte aligned and
// contiguous; the backward takes I a multiple of 8 (its tensor maps' row
// pitch), and writes dB and dC as one partial per 80-channel tile, [ceil(I /
// 80), B, L, 16], and dA as one per batch element, [B, 16, I]. Return a
// cudaError_t code, 0 on success.

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
  if (N != NS || batch <= 0 || L <= 0 || I <= 0 || I % 8 != 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<bf16>(u, delta, A, Bm, Cm, dy, ckpt, du, ddelta, dA_part, dB_part, dC_part, batch, L, I, s);
  if (dtype == 1)
    return launch_bwd<float>(u, delta, A, Bm, Cm, dy, ckpt, du, ddelta, dA_part, dB_part, dC_part, batch, L, I, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
