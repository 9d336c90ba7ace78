// Flash-attention forward for NVIDIA Hopper (sm_90a): TMA tile ring, wgmma
// products, softmax and output kept in registers.
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// multimodal_llm_pretraining_tpu/ops/flash_attention.py:91 (launched by
// _fwd_impl, :383), in its plain and its varlen mode (_flash_varlen,
// :622-652). q, k, v are bf16 [BH, S, D], D in {64, 128, 256} (the wrapper
// zero-pads other head dims up to 256 to the next of these); out is
// [BH, Sq, D] in the output type (bf16 or f32), lse f32 [BH, Sq] = m + log l.
// f32 inputs are rounded to bf16 by the wrapper (ops/flash_attention.py,
// flash_fwd_cuda): one tensor op per input, q*scale computed in f32 and
// rounded once, as a default-precision f32 dot does on the TPU; its time
// counts in the forward's. For bf16 inputs the kernel rounds q*scale itself.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s), at
// the main paths' shapes: pythia-1b [4*8, 2049, 256] causal is bound by its
// products (2 x 2·D per visible pair: 0.070 ms); the CLIP tower's [16*16,
// 577, 64], the llava decoder's [16*32, 1087, 64] causal (varlen) and ViT's
// [128*16, 197, 64] (f32 in, f32 out) by their bytes (0.023, 0.086 and 0.124
// ms). At D=64 the exps cost as much as the products: a 64 x 64 tile takes
// 4096 exps (256 clocks at an SM's 16 a clock) and 2 x 262,144 FMAs (256
// clocks at about 2048 a clock), so the softmax must stay cheap.
//
// The design, against what held the wmma forward back:
// * Copies overlap products. One producer thread issues TMA loads of q, k
//   and v through 3-D tensor maps over [BH, S, D]: rows past S come back as
//   zeros (no branch at the 2049- or 197-row tails) and never cross into the
//   next head. k and v go through a ring of 2 stages, each with its own
//   full barrier for k and for v (so q.k^T starts before v has landed) and
//   one empty barrier every consumer warp arrives on.
// * Products on wgmma. Each consumer warpgroup owns 64 query rows. S =
//   (q*scale).k^T is a 64 x BK wgmma from shared memory (both K-major) into
//   registers; O += P.V takes P from registers and V from shared memory
//   through the transpose bit (V stays row-major [keys, D]; no transpose
//   pass), one m64n64k16 per 64 columns of D. Tiles use the 128-byte
//   swizzle the tensor maps write: a box is 64 bf16 columns (the swizzle
//   span), so a D=128 or D=256 tile is 2 or 4 boxes, each its own region.
// * Scores, softmax and output stay in registers. Each thread holds 2 rows
//   of S and of O; the row max goes over the 4 threads that share a row (2
//   shuffles), the row sum stays per thread until the end. exp is one ex2
//   with log2(e) folded into one FMA. The mask runs only on a tile on the
//   causal diagonal, at the kv tail or at the varlen length; interior tiles
//   skip it, as JAX's num_kb_full split does. O is f32 for the whole k loop
//   (128 registers a thread at D=256) and is stored once.
// * Occupancy and per-block costs, by tile sizes. Shared memory per block
//   (bf16): q BQ x D, plus 2 stages of k and v, each BK x D, plus 56 bytes
//   of barriers and 1 KB to align the base to the swizzle's 1024 bytes:
//     D=64:  BQ  64, BK  64:  8 KB + 2 x (8 + 8) KB   =  40 KB, 3 blocks an SM
//     D=128: BQ 128, BK 128: 32 KB + 2 x (32 + 32) KB = 160 KB, 1 block
//     D=256: BQ 128, BK  64: 64 KB + 2 x (32 + 32) KB = 192 KB (of 227 KB), 1 block
//   At D=256 a 128-key tile would need 64 + 2 x 128 = 320 KB, so BK is 64.
//   D=128 and 256 run two consumer warpgroups (128 q rows) and a producer
//   warpgroup that gives up its registers (setmaxnreg.dec to 40) to the
//   consumers (setmaxnreg.inc to 232: 232 x 256 + 40 x 128 = 64,512 of the
//   SM's 65,536). A consumer thread holds O (D/2 registers), S (BK/2) and P
//   (BK/4 bf16 pairs): 176 at D=256, 160 at D=128. The main paths' D=64
//   sequences are short (197, 577, 1087 keys: 4 to 17 tiles a block), so a
//   block's fixed costs (barrier set-up, the first q and k loads, the
//   epilogue) weigh as much as its products; D=64 therefore runs one
//   consumer warpgroup and a lone producer warp (160 threads, 128 registers
//   each, 80 for O, S and P) in three blocks an SM, whose starts and ends
//   overlap one another's products.
// * Causal blocks run longest first (the last q block is launched first).
//
// Rounding points are the plain version's (ops/flash_attention.py,
// flash_fwd_reference): q*scale rounded to bf16 once (scaled in shared
// memory once per block, then fence.proxy.async before wgmma reads it), P
// rounded to bf16 before P.V, f32 accumulators, l summed from the unrounded
// P. No atomics: a second run gives the same bits. A query row that sees no
// key gives out 0 and lse -1e30; rows past Sq are never stored.
//
// Varlen: a nullable int32 kv_lens [BH] on the device gives each batch-head
// its key count; the k loop ends at min(cdiv(kv_len, BK), causal bound), so
// no tile wholly past kv_len is loaded, and the per-head offsets keep the
// tensor's kv_seq.

#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;

template <int D>
struct FwdTile {
  // D=64: one consumer warpgroup and a lone producer warp, three blocks an
  // SM (one block's start and end overlap the others' products); D=128 and
  // 256: two consumer warpgroups and a producer warpgroup, one block an SM.
  static constexpr int CONSUMERS = D == 64 ? 1 : 2;
  static constexpr int THREADS = CONSUMERS == 1 ? 160 : 384;
  static constexpr int MIN_BLOCKS = CONSUMERS == 1 ? 3 : 1;
  static constexpr int BQ = 64 * CONSUMERS;    // 64 query rows per consumer warpgroup
  static constexpr int BK = D == 128 ? 128 : 64;
  static constexpr int REGIONS = D / 64;       // 64-column (128-byte) boxes per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one k (or v) tile
  static constexpr int q = 0;
  static constexpr int k = q + Q_BYTES;        // STAGES k tiles
  static constexpr int v = k + STAGES * KV_BYTES;
  static constexpr int bars = v + STAGES * KV_BYTES;  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int bytes = bars + 8 * (1 + 3 * STAGES);
  static constexpr int launch_bytes = bytes + 1024;   // room to align the base to 1024
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles must keep the swizzle's 1024-byte alignment");
};

// ---------------------------------------------------------------- the kernel

// One block per (128-row q block, batch-head). Warpgroup 2's first thread
// loads; warpgroups 0 and 1 each compute 64 query rows. Fragment layout of a
// wgmma f32 accumulator (64 x N): thread (warp w, lane) holds rows 16w +
// lane/4 and that + 8, columns 8j + 2(lane%4) + {0, 1}, as d[4j + {0, 1}]
// and d[4j + {2, 3}]; the bf16 A operand from registers uses the same layout
// per 16 columns, so S turns into P in place.
template <int D, typename OutT>
__global__ void __launch_bounds__(FwdTile<D>::THREADS, FwdTile<D>::MIN_BLOCKS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, OutT* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ kv_lens, int q_seq, int kv_seq, int causal, float q_scale) {
  using L = FwdTile<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bars, bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES, bar_e = bar_v + 8 * STAGES;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // causal: the last q blocks see the most keys; launch them first
  const int kv_len = key_count(kv_lens, bh, kv_seq);
  int n_kb = cdiv(kv_len, BK);
  if (causal) n_kb = min(n_kb, cdiv(min(q0 + BQ, q_seq), BK));

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 4 * L::CONSUMERS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == L::CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * L::CONSUMERS && n_kb > 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_k)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_v)) : "memory");
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int r = 0; r < L::REGIONS; ++r) tma_load_3d(base + L::q + r * BQ * 128, &tm_q, r * 64, q0, bh, bar_q);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % STAGES, use = kb / STAGES;
        if (use > 0) mbar_wait(bar_e + 8 * s, (use - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int r = 0; r < L::REGIONS; ++r)
          tma_load_3d(base + L::k + s * L::KV_BYTES + r * BK * 128, &tm_k, r * 64, kb * BK, bh, bar_k + 8 * s);
        mbar_expect_tx(bar_v + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int r = 0; r < L::REGIONS; ++r)
          tma_load_3d(base + L::v + s * L::KV_BYTES + r * BK * 128, &tm_v, r * 64, kb * BK, bh, bar_v + 8 * s);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    if constexpr (L::CONSUMERS == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int row_wg = q0 + wg * 64;                  // this warpgroup's first row
    const int row_lo = row_wg + warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    float acc_o[D / 2];
    float acc_s[BK / 2];
    uint32_t p_frag[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) acc_s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    const uint32_t q_tile = base + L::q + wg * 64 * 128;  // this warpgroup's rows in every region
    if (n_kb > 0) {
      mbar_wait(bar_q, 0);
      if (q_scale != 1.f) {
        // q*scale rounded to bf16 once, in place; zero rows stay zero
        for (int i = tid; i < L::REGIONS * 512; i += 128) {
          uint4* p = reinterpret_cast<uint4*>(smem + L::q + (i / 512) * BQ * 128 + wg * 64 * 128 + (i % 512) * 16);
          uint4 raw16 = *p;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            h[j] = __floats2bfloat162_rn(f.x * q_scale, f.y * q_scale);
          }
          *p = raw16;
        }
      }
      // the generic-proxy writes above become visible to wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % STAGES;
      const uint32_t parity = (kb / STAGES) & 1;
      const int k0 = kb * BK;
      const uint32_t k_tile = base + L::k + s * L::KV_BYTES, v_tile = base + L::v + s * L::KV_BYTES;

      // S = (q*scale) . k^T: both K-major, D/16 steps of 16 columns
      mbar_wait(bar_k + 8 * s, parity);
      fence_regs<BK / 2>(acc_s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the 128-byte row
        const uint64_t da = smem_desc(q_tile + (kk / 4) * BQ * 128 + off, 0, 1024);
        const uint64_t db = smem_desc(k_tile + (kk / 4) * BK * 128 + off, 0, 1024);
        if constexpr (BK == 128) wgmma_m64n128k16_ss(acc_s, da, db, kk > 0);
        else wgmma_m64n64k16_ss(acc_s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(acc_s);

      // the mask, only where a key of this tile may be invisible to a row
      if (k0 + BK > kv_len || (causal && k0 + BK - 1 > row_wg)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + (i / 4) * 8 + 2 * t + (i % 2);
          const int row = row_lo + ((i % 4) >= 2 ? 8 : 0);
          if (key >= kv_len || (causal && key > row)) acc_s[i] = -INFINITY;
        }
      }
      // online softmax: row max over the 4 threads of a row, per-thread sums
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], acc_s[i]);
      float alpha[2], neg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_use = mx[h] == -INFINITY ? 0.f : mx[h];  // a row with no visible key yet
        neg[h] = -m_use * LOG2E;
        alpha[h] = ex2(fmaf(m[h], LOG2E, neg[h]));
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i % 4) / 2;
        const float p = ex2(fmaf(acc_s[i], LOG2E, neg[h]));
        l[h] += p;
        acc_s[i] = p;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) p_frag[kk][j] = pack_bf16(acc_s[8 * kk + 2 * j], acc_s[8 * kk + 2 * j + 1]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_o[i] *= alpha[(i % 4) / 2];

      // O += P . V: V row-major [keys, D] read MN-major, one m64n64k16 per
      // 64-column region (one swizzle atom along N, 8-key groups 1024 B apart)
      mbar_wait(bar_v + 8 * s, parity);
      fence_regs<D / 2>(acc_o);
      fence_regs<BK / 4>(&p_frag[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < L::REGIONS; ++r)
          wgmma_m64n64k16_rs_tb(acc_o + r * 32, p_frag[kk], smem_desc(v_tile + r * BK * 128 + kk * 2048, 1024, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc_o);
      fence_regs<BK / 4>(&p_frag[0][0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);  // this warp is done with stage s
    }

    // out = O / l, lse = m + log l; a row with no visible key (l == 0) gives 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row_lo + 8 * h;
      const float l_safe = l[h] > 0.f ? l[h] : 1.f;
      const float inv = 1.f / l_safe;
      if (row < q_seq) {
        OutT* orow = o + ((size_t)bh * q_seq + row) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          store2<OutT>(orow + 8 * j + 2 * t, acc_o[4 * j + 2 * h] * inv, acc_o[4 * j + 2 * h + 1] * inv);
        if (t == 0) lse[(size_t)bh * q_seq + row] = (m[h] == -INFINITY ? NEG_INF : m[h]) + logf(l_safe);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

template <int D, typename OutT>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, const int* kv_lens, int bh,
               int q_seq, int kv_seq, int causal, float q_scale, cudaStream_t stream) {
  using L = FwdTile<D>;
  static_assert(L::launch_bytes <= 232448, "forward tile set exceeds the 227 KB a block may use");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_rows(fn, &tq, q, bh, q_seq, D, L::BQ) || !encode_rows(fn, &tk, k, bh, kv_seq, D, L::BK) ||
      !encode_rows(fn, &tv, v, bh, kv_seq, D, L::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::launch_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(q_seq, L::BQ), bh);
  flash_fwd_kernel<D, OutT><<<grid, L::THREADS, L::launch_bytes, stream>>>(
      tq, tk, tv, static_cast<OutT*>(o), lse, kv_lens, q_seq, kv_seq, causal, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v: bf16 [bh, S, D], 16-byte
// aligned and contiguous. dtype is the output's: 0 = bfloat16, 1 = float32.
// q_scale multiplies q in the kernel, with one rounding to bf16 (1 skips it:
// the wrapper passes f32 inputs already scaled and rounded). kv_lens: int32
// [bh] on the device for the varlen mode, or nullptr. Returns the
// cudaError_t of the launch (0 on success); nothing is allocated and nothing
// synchronises.
extern "C" int mlpt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, const int* kv_lens,
                              int bh, int q_seq, int kv_seq, int head_dim, int dtype, int causal, float q_scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
#define MLPT_FWD(D, T) return launch_fwd<D, T>(q, k, v, o, lse, kv_lens, bh, q_seq, kv_seq, causal, q_scale, s)
  if (dtype == 0) {
    if (head_dim == 64) MLPT_FWD(64, bf16);
    if (head_dim == 128) MLPT_FWD(128, bf16);
    if (head_dim == 256) MLPT_FWD(256, bf16);
  } else if (dtype == 1) {
    if (head_dim == 64) MLPT_FWD(64, float);
    if (head_dim == 128) MLPT_FWD(128, float);
    if (head_dim == 256) MLPT_FWD(256, float);
  }
#undef MLPT_FWD
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t that one of the library's entry points returned.
extern "C" const char* mlpt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
