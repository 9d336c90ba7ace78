// Flash-attention split backward's dq kernel for NVIDIA Hopper (sm_90a):
// the forward's structure (TMA tile ring, wgmma products, everything a row
// needs kept in registers) with dQ in place of O.
//
// Replaces the Pallas TPU kernel _bwd_dq_kernel of
// multimodal_llm_pretraining_tpu/ops/flash_attention.py:161 (launched by
// _bwd_impl, :572), in its plain and its varlen mode (_flash_varlen,
// :622-652). Its partner, the dk/dv kernel (_bwd_dkv_kernel, :293), is the
// fused backward's kernel compiled without dQ (csrc/flash_bwd.cu,
// mlpt_flash_bwd_dkv); both read the lse and delta rows that the fused
// backward's prep launch writes, once per backward. Per q block it computes
//   s = (q*scale) . k^T, p = exp(s - lse) on visible entries,
//   ds = p * (dp - delta) * scale with dp = dO . v^T, rounded to bf16,
//   dq = sum ds . k (the unscaled k),
// with f32 accumulation. q, k, v, dO are bf16 [BH, S, D], D in {64, 128,
// 256} (the wrapper zero-pads other head dims to the next of these and
// rounds f32 inputs to bf16, q*scale from f32 with one rounding:
// ops/flash_attention.py, split_operands); dq is written once, in the
// output type (bf16, or f32 for f32 inputs). No atomics: a second run gives
// the same bits.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s), at
// the main paths' shapes: pythia-1b [4*8, 2049, 256] causal and the llava
// decoder's [16*32, 1087, 64] causal (varlen) by their products (3 x 2·D
// FLOP per visible pair: 0.104 and 0.118 ms); ViT's [128*16, 197, 64] by
// its bytes (bf16 copies of the f32 inputs in, f32 dq out: 0.093 ms).
//
// The design, against what held the wmma kernel back (synchronous copies by
// every thread, S and dP through shared memory as f32, expf):
// * One block per (q block, batch-head). A producer thread loads the q and
//   dO tiles once, then streams k and v through a ring of STAGES stages by
//   TMA (3-D tensor maps over [BH, S, D], 64-column 128-byte-swizzled
//   boxes, rows past S read as zeros), each stage with a full barrier for k
//   and one for v and one empty barrier every consumer warp arrives on.
// * Each consumer warpgroup owns 64 query rows. q*scale is formed once per
//   block in place in shared memory (bf16 inputs; f32 inputs come scaled),
//   then fence.proxy.async. S = (q*scale) . k^T and dP = dO . v^T are wgmma
//   products from shared memory (both K-major) into registers; p = ex2 with
//   log2(e) folded into one FMA, and ds, stay in registers, the mask only on
//   tiles on the causal diagonal, at the key tail or at the varlen length.
//   dQ += dS . k takes dS from registers as the A operand (the accumulator's
//   fragment layout is the A operand's, per 16 columns) and k read MN-major
//   through the transpose bit: the forward's P . V with v replaced by k.
//   dQ stays f32 in registers for the whole k loop and is stored once.
// * lse and delta of a thread's two rows are read once from the prep
//   launch's padded rows, into registers.
// * Tile sets and budgets (bf16, BK = 64 keys):
//     D=64:  BQ 64, one consumer warpgroup and a lone producer warp (160
//            threads), q 8 + dO 8 + 2 x (k 8 + v 8) KB = 48 KB, several
//            blocks an SM; a consumer thread holds dQ, S and dP (32
//            registers each) and dS (16).
//     D=128: BQ 128, two consumer warpgroups and a producer warpgroup (384
//            threads, setmaxnreg 232 / 40), 32 + 32 + 2 x (16 + 16) = 128
//            KB; dQ 64 registers.
//     D=256: BQ 128, two consumer warpgroups as at D=128 (setmaxnreg 232:
//            dQ 128 + S 32 + dP 32 + dS 16 registers), 64 + 64 + one stage
//            of (32 + 32) = 192 KB, one block an SM. A stage's next k and v
//            load only once both warpgroups are done with it, but the two
//            warpgroups drift apart (one in its softmax while the other's
//            products run), and each k and v tile serves 128 query rows.
//            That measured 0.305 ms a call at pythia-1b's shape on an H100
//            80GB HBM3 at 700 W against 0.414 ms for BQ 64 with one consumer warpgroup (up to 255
//            registers) over a two-stage ring in the same 192 KB
//            (D256_CONSUMERS = 1; time_flash_variants.py).
// * Causal blocks run longest first (the last q block is launched first);
//   the k loop ends at min(cdiv(kv_len, BK), causal bound), so no tile
//   wholly past kv_len is loaded.
//
// Rounding points are the plain version's (ops/flash_attention.py,
// flash_bwd_dq_reference): q*scale rounded to bf16 once, ds rounded to bf16
// before ds . k, f32 accumulators. A query row that sees no key gives dq 0;
// rows past Sq are never stored.
//
// Varlen: a nullable int32 kv_lens [BH] on the device gives each batch-head
// its key count; keys at or past it are invisible to every query row, padded
// rows included, and the per-head offsets keep the tensor's kv_seq.

#include "hopper.cuh"

namespace {

constexpr int STATS_ROWS = 64;      // the prep launch pads lse and delta rows to a multiple of this
constexpr int D256_CONSUMERS = 2;   // D=256: two consumer warpgroups (one stage) or one (two stages)

template <int D>
struct DqTile {
  static constexpr int CONSUMERS = D == 128 ? 2 : D == 256 ? D256_CONSUMERS : 1;
  static constexpr int STAGES = D == 256 && CONSUMERS == 2 ? 1 : 2;
  static constexpr int THREADS = CONSUMERS == 1 ? 160 : 384;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;  // D=64: registers budgeted for three blocks an SM
  static constexpr int BQ = 64 * CONSUMERS, BK = 64;  // 64 query rows per consumer warpgroup
  static constexpr int REGIONS = D / 64;              // 64-column (128-byte) boxes per row
  static constexpr int Q_BYTES = BQ * D * 2;          // one q (or dO) tile
  static constexpr int KV_BYTES = BK * D * 2;         // one k (or v) tile
  static constexpr int q = 0;
  static constexpr int dout = q + Q_BYTES;
  static constexpr int k = dout + Q_BYTES;            // STAGES k tiles
  static constexpr int v = k + STAGES * KV_BYTES;     // STAGES v tiles
  static constexpr int bars = v + STAGES * KV_BYTES;  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int bytes = bars + 8 * (1 + 3 * STAGES);
  static constexpr int launch_bytes = bytes + 1024;   // room to align the base to 1024
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles must keep the swizzle's 1024-byte alignment");
};

// ---------------------------------------------------------------- the kernel

template <int D, typename OutT>
__global__ void __launch_bounds__(DqTile<D>::THREADS, DqTile<D>::MIN_BLOCKS)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kv_lens, OutT* __restrict__ dq, int q_seq, int kv_seq, int causal,
                        float sm_scale, float q_scale) {
  using L = DqTile<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
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
    // ---- producer: one thread loads q and dO once, then keeps the k/v ring full
    if constexpr (L::CONSUMERS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * L::CONSUMERS && n_kb > 0) {
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      mbar_expect_tx(bar_q, 2 * L::Q_BYTES);
#pragma unroll
      for (int r = 0; r < L::REGIONS; ++r) {
        tma_load_3d(base + L::q + r * BQ * 128, &tm_q, r * 64, q0, bh, bar_q);
        tma_load_3d(base + L::dout + r * BQ * 128, &tm_do, r * 64, q0, bh, bar_q);
      }
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
    const int row_wg = q0 + wg * 64;                   // this warpgroup's first row
    const int row_lo = row_wg + warp * 16 + lane / 4;  // this thread's rows: row_lo and row_lo + 8
    float acc_dq[D / 2];
    float acc_s[BK / 2], acc_dp[BK / 2];
    uint32_t ds_frag[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;

    // this thread's rows' -lse in log2 units and delta; a row past Sq gets
    // p = 0 (its q and dO rows are zeros)
    const size_t stats_row = (size_t)bh * (cdiv(q_seq, STATS_ROWS) * STATS_ROWS);
    float neg_l[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      neg_l[h] = row < q_seq ? -lse[stats_row + row] * LOG2E : -INFINITY;
      dl[h] = row < q_seq ? delta[stats_row + row] : 0.f;
    }

    const uint32_t q_tile = base + L::q + wg * 64 * 128, do_tile = base + L::dout + wg * 64 * 128;
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
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }

    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % STAGES;
      const uint32_t parity = (kb / STAGES) & 1;
      const int k0 = kb * BK;
      const uint32_t k_tile = base + L::k + s * L::KV_BYTES, v_tile = base + L::v + s * L::KV_BYTES;

      // S = (q*scale) . k^T, then dP = dO . v^T: all K-major, D/16 steps of
      // 16 columns; S starts before v has landed
      mbar_wait(bar_k + 8 * s, parity);
      fence_regs<BK / 2>(acc_s);
      fence_regs<BK / 2>(acc_dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the 128-byte row
        wgmma_m64n64k16_ss(acc_s, smem_desc(q_tile + (kk / 4) * BQ * 128 + off, 0, 1024),
                           smem_desc(k_tile + (kk / 4) * BK * 128 + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
      mbar_wait(bar_v + 8 * s, parity);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_m64n64k16_ss(acc_dp, smem_desc(do_tile + (kk / 4) * BQ * 128 + off, 0, 1024),
                           smem_desc(v_tile + (kk / 4) * BK * 128 + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(acc_s);
      fence_regs<BK / 2>(acc_dp);

      // p = exp(s - lse) on visible entries and ds = p (dp - delta) scale,
      // rounded to bf16 A fragments; the mask only where a key of this tile
      // may be invisible to a row of this warpgroup
      const bool masked = k0 + BK > kv_len || (causal && k0 + BK - 1 > row_wg);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i % 4) / 2;
        float p = ex2(fmaf(acc_s[i], LOG2E, neg_l[h]));
        if (masked) {
          const int key = k0 + (i / 4) * 8 + 2 * t + (i % 2);
          if (key >= kv_len || (causal && key > row_lo + 8 * h)) p = 0.f;
        }
        acc_s[i] = p * (acc_dp[i] - dl[h]) * sm_scale;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ds_frag[kk][j] = pack_bf16(acc_s[8 * kk + 2 * j], acc_s[8 * kk + 2 * j + 1]);
      }

      // dQ += dS . k: k row-major [keys, D] read MN-major, one m64n64k16 per
      // 64-column region (one swizzle atom along N, 8-key groups 1024 B apart)
      fence_regs<D / 2>(acc_dq);
      fence_regs<BK / 4>(&ds_frag[0][0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < L::REGIONS; ++r)
          wgmma_m64n64k16_rs_tb(acc_dq + r * 32, ds_frag[kk], smem_desc(k_tile + r * BK * 128 + kk * 2048, 1024, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc_dq);
      fence_regs<BK / 4>(&ds_frag[0][0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);  // this warp is done with stage s
    }

    // dq, stored once in the output type; rows past Sq are not stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < q_seq) {
        OutT* drow = dq + ((size_t)bh * q_seq + row) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) store2<OutT>(drow + 8 * j + 2 * t, acc_dq[4 * j + 2 * h], acc_dq[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

template <int D, typename OutT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
              const int* kv_lens, void* dq, int bh, int q_seq, int kv_seq, int causal, float sm_scale, float q_scale,
              cudaStream_t stream) {
  using L = DqTile<D>;
  static_assert(L::launch_bytes <= 232448, "dq tile set exceeds the 227 KB a block may use");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_rows(fn, &tq, q, bh, q_seq, D, L::BQ) || !encode_rows(fn, &tdo, dout, bh, q_seq, D, L::BQ) ||
      !encode_rows(fn, &tk, k, bh, kv_seq, D, L::BK) || !encode_rows(fn, &tv, v, bh, kv_seq, D, L::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::launch_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(q_seq, L::BQ), bh);
  flash_bwd_dq_kernel<D, OutT><<<grid, L::THREADS, L::launch_bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, kv_lens, static_cast<OutT*>(dq), q_seq, kv_seq, causal, sm_scale, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v, dout: bf16 [bh, S, D],
// 16-byte aligned and contiguous; q_scale multiplies q in the kernel, with
// one rounding to bf16 (1 skips it: the wrapper passes f32 inputs already
// scaled and rounded). lse, delta: f32 [bh, cdiv(q_seq, 64) * 64] from the
// prep launch (mlpt_flash_bwd_prep). dq: [bh, q_seq, D] in dtype (0 =
// bfloat16, 1 = float32). kv_lens: int32 [bh] on the device for the varlen
// mode, or nullptr. Returns the cudaError_t of the launch (0 on success);
// nothing is allocated and nothing synchronises.
extern "C" int mlpt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                 const float* delta, const int* kv_lens, void* dq, int bh, int q_seq, int kv_seq,
                                 int head_dim, int dtype, int causal, float sm_scale, float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
#define MLPT_DQ(D, T) \
  return launch_dq<D, T>(q, k, v, dout, lse, delta, kv_lens, dq, bh, q_seq, kv_seq, causal, sm_scale, q_scale, s)
  if (dtype == 0) {
    if (head_dim == 64) MLPT_DQ(64, bf16);
    if (head_dim == 128) MLPT_DQ(128, bf16);
    if (head_dim == 256) MLPT_DQ(256, bf16);
  } else if (dtype == 1) {
    if (head_dim == 64) MLPT_DQ(64, float);
    if (head_dim == 128) MLPT_DQ(128, float);
    if (head_dim == 256) MLPT_DQ(256, float);
  }
#undef MLPT_DQ
  return (int)cudaErrorInvalidValue;
}
