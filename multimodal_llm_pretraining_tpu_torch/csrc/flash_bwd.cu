// Flash-attention fused backward for NVIDIA Hopper (sm_90a): TMA tile ring,
// wgmma products, dk and dv in registers, dq by vector reductions.
//
// Replaces the Pallas TPU kernel _bwd_fused_kernel of
// multimodal_llm_pretraining_tpu/ops/flash_attention.py:208 (launched by
// _bwd_impl, :535), in its plain and its varlen mode (_flash_varlen,
// :622-652). It computes, from one P and dS tile per (k block, q block):
//   s = q . (k*scale)^T, p = exp(s - lse) on visible entries,
//   ds = p * (dp - delta) * scale with dp = dO . v^T, rounded to bf16,
//   dv = sum p^T . dO, dk = sum ds^T . q, dq = sum ds . k (the unscaled k),
// with f32 accumulation. q, k, v, dO are bf16 [BH, S, D], D in {64, 128,
// 256} (the wrapper zero-pads other head dims to the next of these and
// rounds f32 inputs to bf16: ops/flash_attention.py, flash_bwd_cuda). dk and
// dv are written in the output type (bf16, or f32 for f32 inputs), dq is
// added into a zeroed f32 [BH, Sq, D] buffer.
//
// A call is two launches. flash_bwd_prep_kernel reads out and dO in the
// input type and writes delta = rowsum(dO * out) in f32 (the plain version's
// bwd_delta, taken before any rounding) and lse, both as f32 [BH, Sq rounded
// up to 64], lse padded with +inf and delta with 0: a query row past Sq then
// gets p = 0 without a mask, and every q block's 256 bytes of either load by
// one bulk copy (a row of Sq = 2049 floats is not a multiple of 16 bytes, so
// no TMA map could cover the unpadded rows). One pass over out and dO, where
// the same in PyTorch took an f32 copy of each, a product and a reduction.
// Then flash_bwd_kernel.
//
// Rounding points are the plain version's (ops/flash_attention.py,
// _bwd_probs): k*scale rounded to bf16, p and ds rounded to bf16 before their
// products. Where the scale is a power of two (D=64: 2^-3, D=256: 2^-4)
// bf16(k*scale) is k*scale exactly, and so is the f32 product scaled after
// the fact: the scores are multiplied by the scale in registers, and no
// scaled k tile is made (at D=256 there is no shared memory for one).
// Otherwise (D=128, and the head dims padded to 64 or 128) bf16(k*scale) is
// formed once per block in its own tile of shared memory from the loaded k
// tile (a same-offset pass keeps the swizzle), then fence.proxy.async. The
// wrapper refuses D=256 with a scale that is not a power of two.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s), at
// the main paths' shapes: pythia-1b [4*8, 2049, 256] causal and the llava
// decoder's [16*32, 1087, 64] causal (varlen) by their products (5 x 2·D
// FLOP per visible pair: 0.174 and 0.196 ms); ViT's [128*16, 197, 64] (f32 in
// and out) by its bytes (0.247 ms).
//
// The design:
// * One block per (64-row k block, batch-head), looping over the 64-row q
//   blocks from the causal diagonal to the end (none for a k block wholly
//   past kv_len). A producer thread loads the block's k and v tiles once,
//   then streams each q block's q and dO tiles and its lse and delta rows
//   through a 2-stage ring of full/empty mbarriers. Tiles come by TMA through
//   3-D tensor maps over [BH, S, D] in 64-column, 128-byte-swizzled boxes;
//   rows past S read as zeros.
// * Consumer warpgroups compute S^T = (k*scale) . q^T and dP^T = v . dO^T
//   with wgmma from shared memory (both K-major; M = the 64 keys), mask
//   (only on tiles on the causal diagonal, at the key tail or at the varlen
//   length) and exponentiate in registers, and write P^T and dS^T as bf16
//   into swizzled [64 keys x 64 queries] tiles (double-buffered by q block,
//   so one named barrier an iteration orders writes and reads). Then dV +=
//   P^T . dO and dK += dS^T . q (A from those tiles K-major, B = dO or q read
//   MN-major through the transpose bit, as the forward reads v), and dQ =
//   dS . k (A = the dS^T tile read MN-major, B = the unscaled k tile
//   MN-major), one 64-column region of D at a time, added to the f32 dq
//   buffer four floats per vector atomic (two lanes swap halves of their
//   fragments so each holds 4 adjacent columns of one row). dk and dv
//   stay f32 in registers for the whole q loop and are stored once.
// * Tile sets and budgets (bf16; STAGES = 2; P^T and dS^T 2 x 2 x 8 KB):
//     D=64:  one consumer warpgroup and a lone producer warp (160 threads),
//            k, k*scale, v 3 x 8 KB + 2 x (q 8 + dO 8) KB + 32 KB = 88 KB,
//            two blocks an SM. A consumer thread holds S^T and dP^T (64 x 64:
//            32 registers each), dK and dV (32 each) and one dQ region (32).
//            (128-key blocks over two consumer warpgroups, sharing each q
//            block's loads, one block an SM, were 8-11% slower at the D=64
//            main-path shapes: two independent blocks overlap each other's
//            serial phases.)
//     D=128: two consumer warpgroups and a producer warpgroup (384 threads,
//            setmaxnreg 232 / 40), 3 x 16 + 2 x 32 + 32 = 144 KB. Warpgroup
//            w computes S^T and dP^T for queries [32w, 32w + 32) (64 x 32:
//            16 registers each) and dK, dV, dQ for D columns [64w, 64w + 64)
//            (32 each).
//     D=256: as D=128 without the k*scale tile, 2 x 32 + 2 x 64 + 32 = 224
//            KB of the 227; a consumer holds S^T, dP^T (16 each), dK and dV
//            for its 128 columns (64 each) and one 64-column dQ region (32):
//            192 registers of its 232. (64 keys of dK and dV over one
//            warpgroup would be 256 registers a thread, over the 255 limit.)
// * Causal blocks: the first k blocks see the most q blocks and are launched
//   first (blockIdx.x = 0 is k block 0).
//
// dq's sum across k blocks is taken by atomics in an order that changes from
// run to run, so dq may move by one ulp between runs; dk and dv are each
// summed in one block in a fixed order and repeat bit for bit. dk and dv
// rows at and past kv_len are exactly 0 (every P^T and dS^T entry there is
// 0), and a k block no query sees stores zeros.
//
// Varlen: a nullable int32 kv_lens [BH] on the device gives each batch-head
// its key count; keys at or past it are invisible to every query row, padded
// rows included, and the per-head offsets keep the tensor's kv_seq.

#include "hopper.cuh"

namespace {

constexpr int STAGES = 2;

template <int D>
struct BwdTile {
  static constexpr int CONSUMERS = D == 64 ? 1 : 2;
  static constexpr int THREADS = CONSUMERS == 1 ? 160 : 384;
  static constexpr int MIN_BLOCKS = CONSUMERS == 1 ? 2 : 1;
  static constexpr int BK = 64, BQ = 64;          // keys and queries per tile
  static constexpr int QCOLS = BQ / CONSUMERS;    // S^T columns (queries) per consumer warpgroup
  static constexpr int REGIONS = D / 64;          // 64-column (128-byte) boxes per row
  static constexpr int DREG = REGIONS / CONSUMERS;  // regions of dK, dV, dQ per consumer warpgroup
  static constexpr bool KS = D != 256;            // room for a k*scale tile
  static constexpr int KV_BYTES = BK * D * 2;     // one k (or v) tile
  static constexpr int Q_BYTES = BQ * D * 2;      // one q (or dO) tile
  static constexpr int PS_BYTES = BK * BQ * 2;    // one P^T (or dS^T) tile
  static constexpr int STAT_BYTES = BQ * 4;       // one q block's lse (or delta)
  static constexpr int k = 0;
  static constexpr int ks = k + KV_BYTES;
  static constexpr int v = ks + (KS ? KV_BYTES : 0);
  static constexpr int q = v + KV_BYTES;             // STAGES q tiles
  static constexpr int dout = q + STAGES * Q_BYTES;  // STAGES dO tiles
  static constexpr int p = dout + STAGES * Q_BYTES;  // 2 P^T tiles, by q block parity
  static constexpr int ds = p + 2 * PS_BYTES;        // 2 dS^T tiles
  static constexpr int stats = ds + 2 * PS_BYTES;    // STAGES x (lse, delta)
  static constexpr int bars = stats + STAGES * 2 * STAT_BYTES;  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES);
  static constexpr int launch_bytes = bytes + 1024;  // room to align the base to 1024
  static_assert(KV_BYTES % 1024 == 0 && Q_BYTES % 1024 == 0 && PS_BYTES % 1024 == 0,
                "tiles must keep the swizzle's 1024-byte alignment");
  static_assert(QCOLS % 32 == 0 && DREG >= 1, "a consumer warpgroup takes 32 or 64 queries and whole regions");
};

// dq += v at p (16-byte aligned): one vector reduction in global memory.
__device__ __forceinline__ void add4(float* p, float4 v) { atomicAdd(reinterpret_cast<float4*>(p), v); }

// ---------------------------------------------------------------- delta and the padded lse

constexpr int PREP_THREADS = 256, PREP_LANES = 8;  // 8 lanes a query row, 32 rows a block

// delta[row] = sum_d dO[row, d] * out[row, d] in f32 and lse[row], for every
// row of the padded [bh, stats_stride] layout (rows past q_seq: delta 0, lse
// +inf). out and dout are [bh, q_seq, d] in T, d a multiple of 64.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
    flash_bwd_prep_kernel(const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ lse_pad, float* __restrict__ delta_pad, int bh, int q_seq,
                          int stats_stride, int d) {
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte load
  const long row = (long)blockIdx.x * (PREP_THREADS / PREP_LANES) + threadIdx.x / PREP_LANES;
  const int lane = threadIdx.x % PREP_LANES;
  const bool valid = row < (long)bh * stats_stride;
  const int b = valid ? (int)(row / stats_stride) : 0, qi = valid ? (int)(row % stats_stride) : q_seq;
  float acc = 0.f;
  if (qi < q_seq) {
    const size_t base = ((size_t)b * q_seq + qi) * d;
    for (int c = lane * VEC; c < d; c += PREP_LANES * VEC) {
      const uint4 ro = *reinterpret_cast<const uint4*>(out + base + c);
      const uint4 rd = *reinterpret_cast<const uint4*>(dout + base + c);
      const T* o = reinterpret_cast<const T*>(&ro);
      const T* g = reinterpret_cast<const T*>(&rd);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc = fmaf(to_float(g[i]), to_float(o[i]), acc);
    }
  }
#pragma unroll
  for (int m = PREP_LANES / 2; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (valid && lane == 0) {
    delta_pad[row] = acc;
    lse_pad[row] = qi < q_seq ? lse[(size_t)b * q_seq + qi] : INFINITY;
  }
}

// ---------------------------------------------------------------- the kernel

template <int D, typename OutT>
__global__ void __launch_bounds__(BwdTile<D>::THREADS, BwdTile<D>::MIN_BLOCKS)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_lens, float* __restrict__ dq, OutT* __restrict__ dk,
                     OutT* __restrict__ dv, int q_seq, int kv_seq, int causal, float sm_scale, int scale_k) {
  using L = BwdTile<D>;
  constexpr int BK = L::BK, BQ = L::BQ, QCOLS = L::QCOLS, DREG = L::DREG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::bars, bar_full = bar_kv + 8, bar_empty = bar_full + 8 * STAGES;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int kv_len = key_count(kv_lens, bh, kv_seq);
  const int qb_start = causal ? k0 / BQ : 0;  // the first q block with a query at or after key k0
  const int n_iter = k0 < kv_len ? max(cdiv(q_seq, BQ) - qb_start, 0) : 0;
  const int stats_stride = cdiv(q_seq, BQ) * BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * L::CONSUMERS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == L::CONSUMERS) {
    // ---- producer: one thread loads k and v once, then keeps the q/dO ring full
    if constexpr (L::CONSUMERS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * L::CONSUMERS && n_iter > 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_do);
      mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
#pragma unroll
      for (int r = 0; r < L::REGIONS; ++r) {
        tma_load_3d(base + L::k + r * BK * 128, &tm_k, r * 64, k0, bh, bar_kv);
        tma_load_3d(base + L::v + r * BK * 128, &tm_v, r * 64, k0, bh, bar_kv);
      }
      const float* lse_row = lse + (size_t)bh * stats_stride;
      const float* delta_row = delta + (size_t)bh * stats_stride;
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES, use = it / STAGES;
        const int q0 = (qb_start + it) * BQ;
        const uint32_t full = bar_full + 8 * s;
        if (use > 0) mbar_wait(bar_empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full, 2 * L::Q_BYTES + 2 * L::STAT_BYTES);
#pragma unroll
        for (int r = 0; r < L::REGIONS; ++r) {
          tma_load_3d(base + L::q + s * L::Q_BYTES + r * BQ * 128, &tm_q, r * 64, q0, bh, full);
          tma_load_3d(base + L::dout + s * L::Q_BYTES + r * BQ * 128, &tm_do, r * 64, q0, bh, full);
        }
        const uint32_t st = base + L::stats + s * 2 * L::STAT_BYTES;
        bulk_load(st, lse_row + q0, L::STAT_BYTES, full);
        bulk_load(st + L::STAT_BYTES, delta_row + q0, L::STAT_BYTES, full);
      }
    }
  } else {
    // ---- consumers
    if constexpr (L::CONSUMERS == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int r_lo = warp * 16 + lane / 4;  // this thread's accumulator rows: r_lo and r_lo + 8
    const int qcol0 = wg * QCOLS;           // this warpgroup's S^T columns (queries in the q block)
    const int reg0 = wg * DREG;             // this warpgroup's first region of dK, dV, dQ
    float acc_dk[DREG * 32], acc_dv[DREG * 32];
    float acc_s[QCOLS / 2], acc_dp[QCOLS / 2];
#pragma unroll
    for (int i = 0; i < DREG * 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < QCOLS / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;

    // the scores' operand and their factor to log2 units: k*scale from its
    // own tile, or k with the (power-of-two) scale applied to the f32 scores
    bool use_ks = false;
    if constexpr (L::KS) use_ks = scale_k != 0;
    const uint32_t kx_tile = base + (use_ks ? L::ks : L::k);
    const float s_mul = use_ks ? LOG2E : sm_scale * LOG2E;

    if (n_iter > 0) {
      mbar_wait(bar_kv, 0);
      if constexpr (L::KS) {
        if (use_ks) {
          // k*scale rounded to bf16 once, at the same swizzled offsets; zero rows stay zero
          for (int i = threadIdx.x; i < L::KV_BYTES / 16; i += 128 * L::CONSUMERS) {
            uint4 raw16 = *reinterpret_cast<const uint4*>(smem + L::k + i * 16);
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw16);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h[j]);
              h[j] = __floats2bfloat162_rn(f.x * sm_scale, f.y * sm_scale);
            }
            *reinterpret_cast<uint4*>(smem + L::ks + i * 16) = raw16;
          }
          fence_proxy_async();
          named_sync(1, 128 * L::CONSUMERS);
        }
      }
    }

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int q0 = (qb_start + it) * BQ;
      const uint32_t q_tile = base + L::q + s * L::Q_BYTES, do_tile = base + L::dout + s * L::Q_BYTES;
      const int p_off = L::p + (it & 1) * L::PS_BYTES, ds_off = L::ds + (it & 1) * L::PS_BYTES;
      const float* st = reinterpret_cast<const float*>(smem + L::stats + s * 2 * L::STAT_BYTES);

      // S^T = (k*scale) . q^T and dP^T = v . dO^T for this warpgroup's
      // queries: both operands K-major, D/16 steps of 16 columns
      mbar_wait(bar_full + 8 * s, parity);
      fence_regs<QCOLS / 2>(acc_s);
      fence_regs<QCOLS / 2>(acc_dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;  // BK == BQ: one offset for both
        const uint64_t dk_ = smem_desc(kx_tile + off, 0, 1024);
        const uint64_t dq_ = smem_desc(q_tile + qcol0 * 128 + off, 0, 1024);
        if constexpr (QCOLS == 64) wgmma_m64n64k16_ss(acc_s, dk_, dq_, kk > 0);
        else wgmma_m64n32k16_ss(acc_s, dk_, dq_, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint64_t dv_ = smem_desc(base + L::v + off, 0, 1024);
        const uint64_t do_ = smem_desc(do_tile + qcol0 * 128 + off, 0, 1024);
        if constexpr (QCOLS == 64) wgmma_m64n64k16_ss(acc_dp, dv_, do_, kk > 0);
        else wgmma_m64n32k16_ss(acc_dp, dv_, do_, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<QCOLS / 2>(acc_s);
      fence_regs<QCOLS / 2>(acc_dp);

      // P^T = exp(s - lse) on visible entries and dS^T = P^T (dP^T - delta)
      // scale, each rounded to bf16 into its swizzled tile; the mask only
      // where a key of this tile may be invisible to a query of this block
      const bool masked = k0 + BK > kv_len || (causal && k0 + BK - 1 > q0);
#pragma unroll
      for (int j = 0; j < QCOLS / 8; ++j) {
        const int c = qcol0 + 8 * j + 2 * t;  // query column in the q block
        const float2 l2 = *reinterpret_cast<const float2*>(st + c);
        const float2 d2 = *reinterpret_cast<const float2*>(st + BQ + c);
        const float neg_l[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + 8 * h;  // key row in the k block
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float pe = ex2(fmaf(acc_s[i], s_mul, neg_l[e]));
            if (masked) {
              const int key = k0 + r;
              if (key >= kv_len || (causal && q0 + c + e < key)) pe = 0.f;
            }
            p[e] = pe;
            ds[e] = pe * (acc_dp[i] - dl[e]) * sm_scale;
          }
          const uint32_t o = swizzled_offset(r, c);
          *reinterpret_cast<uint32_t*>(smem + p_off + o) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(smem + ds_off + o) = pack_bf16(ds[0], ds[1]);
        }
      }
      // the generic-proxy writes above become visible to wgmma, and every
      // consumer warpgroup's half of both tiles is in place
      fence_proxy_async();
      named_sync(1, 128 * L::CONSUMERS);

      // dV += P^T . dO and dK += dS^T . q over this warpgroup's regions of D:
      // A K-major (queries contiguous), B MN-major
      fence_regs<DREG * 32>(acc_dv);
      fence_regs<DREG * 32>(acc_dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t dp_ = smem_desc(base + p_off + kk * 32, 0, 1024);
        const uint64_t ds_ = smem_desc(base + ds_off + kk * 32, 0, 1024);
#pragma unroll
        for (int rr = 0; rr < DREG; ++rr) {
          const uint32_t off = (reg0 + rr) * BQ * 128 + kk * 2048;
          wgmma_m64n64k16_ss<0, 1>(acc_dv + rr * 32, dp_, smem_desc(do_tile + off, 1024, 1024), 1);
          wgmma_m64n64k16_ss<0, 1>(acc_dk + rr * 32, ds_, smem_desc(q_tile + off, 1024, 1024), 1);
        }
      }
      wgmma_commit();

      // dQ = dS . k, one 64-column region at a time: A = the dS^T tile read
      // MN-major (queries contiguous), B = the unscaled k tile MN-major
#pragma unroll
      for (int rr = 0; rr < DREG; ++rr) {
        float acc_dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_dq[i] = 0.f;
        fence_regs<32>(acc_dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n64k16_ss<1, 1>(acc_dq, smem_desc(base + ds_off + kk * 2048, 1024, 1024),
                                   smem_desc(base + L::k + (reg0 + rr) * BK * 128 + kk * 2048, 1024, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(acc_dq);
        if (rr == 0) {
          // dV and dK are done with this stage's q and dO: release it
          fence_regs<DREG * 32>(acc_dv);
          fence_regs<DREG * 32>(acc_dk);
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * s);
        }
        // lanes t and t^1 swap halves: an even t adds 4 columns of row r_lo,
        // an odd t 4 columns of row r_lo + 8, one 16-byte reduction each
        const int odd = t & 1, qi = q0 + r_lo + 8 * odd;
        float* row = dq + ((size_t)bh * q_seq + qi) * D + (reg0 + rr) * 64 + 2 * (t - odd);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* d = acc_dq + 4 * j;
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
          const float4 v4 = odd ? make_float4(s0, s1, d[2], d[3]) : make_float4(d[0], d[1], s0, s1);
          if (qi < q_seq) add4(row + 8 * j, v4);
        }
      }
    }

    // dk and dv, stored once; rows past kv_seq are not stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + r_lo + 8 * h;
      if (row < kv_seq) {
        const size_t off = ((size_t)bh * kv_seq + row) * D + reg0 * 64 + 2 * t;
#pragma unroll
        for (int rr = 0; rr < DREG; ++rr) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = rr * 32 + 4 * j + 2 * h;
            store2<OutT>(dk + off + rr * 64 + 8 * j, acc_dk[i], acc_dk[i + 1]);
            store2<OutT>(dv + off + rr * 64 + 8 * j, acc_dv[i], acc_dv[i + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host side

bool power_of_two(float x) {
  int e;
  return x > 0.f && frexpf(x, &e) == 0.5f;
}

template <int D, typename OutT>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* o_in, const void* do_in,
               const float* lse_in, float* lse, float* delta, const int* kv_lens, float* dq, void* dk, void* dv,
               int bh, int q_seq, int kv_seq, int causal, float sm_scale, cudaStream_t stream) {
  using L = BwdTile<D>;
  static_assert(L::launch_bytes <= 232448, "backward tile set exceeds the 227 KB a block may use");
  const int scale_k = power_of_two(sm_scale) ? 0 : 1;
  if (scale_k && !L::KS) return (int)cudaErrorInvalidValue;  // no room for a k*scale tile
  const int stats_stride = cdiv(q_seq, L::BQ) * L::BQ;
  const long rows = (long)bh * stats_stride;
  flash_bwd_prep_kernel<OutT><<<(unsigned)((rows + PREP_THREADS / PREP_LANES - 1) / (PREP_THREADS / PREP_LANES)),
                                PREP_THREADS, 0, stream>>>(static_cast<const OutT*>(o_in),
                                                           static_cast<const OutT*>(do_in), lse_in, lse, delta, bh,
                                                           q_seq, stats_stride, D);
  cudaError_t prep = cudaGetLastError();
  if (prep != cudaSuccess) return (int)prep;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_rows(fn, &tq, q, bh, q_seq, D, L::BQ) || !encode_rows(fn, &tdo, dout, bh, q_seq, D, L::BQ) ||
      !encode_rows(fn, &tk, k, bh, kv_seq, D, L::BK) || !encode_rows(fn, &tv, v, bh, kv_seq, D, L::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::launch_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(kv_seq, L::BK), bh);
  flash_bwd_kernel<D, OutT><<<grid, L::THREADS, L::launch_bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, kv_lens, dq, static_cast<OutT*>(dk), static_cast<OutT*>(dv), q_seq, kv_seq,
      causal, sm_scale, scale_k);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v, dout: bf16 [bh, S, D],
// 16-byte aligned and contiguous. o_in, do_in: out and dO [bh, q_seq, D] in
// the input type (dtype; for bf16 inputs do_in may be dout), contiguous.
// lse_in: f32 [bh, q_seq] from the forward. lse, delta: f32 scratch of [bh,
// cdiv(q_seq, 64) * 64] that the first launch fills. dq: a zeroed f32 [bh,
// q_seq, D] that the kernel adds into. dtype is the input type and dk's and
// dv's: 0 = bfloat16, 1 = float32. kv_lens: int32 [bh] on the device for the
// varlen mode, or nullptr. At D=256 sm_scale must be a power of two. Returns
// the cudaError_t of the launches (0 on success); nothing is allocated and
// nothing synchronises.
extern "C" int mlpt_flash_bwd(const void* q, const void* k, const void* v, const void* dout, const void* o_in,
                              const void* do_in, const float* lse_in, float* lse, float* delta, const int* kv_lens,
                              float* dq, void* dk, void* dv, int bh, int q_seq, int kv_seq, int head_dim, int dtype,
                              int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
#define MLPT_BWD(D, T)                                                                                            \
  return launch_bwd<D, T>(q, k, v, dout, o_in, do_in, lse_in, lse, delta, kv_lens, dq, dk, dv, bh, q_seq, kv_seq, \
                          causal, sm_scale, s)
  if (dtype == 0) {
    if (head_dim == 64) MLPT_BWD(64, bf16);
    if (head_dim == 128) MLPT_BWD(128, bf16);
    if (head_dim == 256) MLPT_BWD(256, bf16);
  } else if (dtype == 1) {
    if (head_dim == 64) MLPT_BWD(64, float);
    if (head_dim == 128) MLPT_BWD(128, float);
    if (head_dim == 256) MLPT_BWD(256, float);
  }
#undef MLPT_BWD
  return (int)cudaErrorInvalidValue;
}
