// Mamba-2's chunk scan (SSD: Dao & Gu 2024, arXiv:2405.21060), forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Mamba-2. ops/ssd.py computes the cumulative decay, each
// chunk's own state, the states passed between chunks and C B^T (PyTorch and cuBLAS), then these kernels the
// part whose naive form materialises a [chunk, chunk] decay mask for every head: with acs the cumulative
// dt A of the chunk (f32), M[t, s] = CB[t, s] exp(acs_t - acs_s) dt_s for s <= t, else 0,
//
//   ssd_fwd_kernel: y[t] = sum_s M[t, s] x[s] + exp(acs_t) C_t . state + D x_t,
//     the state the one entering the chunk ([P, N], bf16), y rounded once to bf16;
//   ssd_bwd_kernel: for each step s of a chunk, with G[t, s] = dy_t . x_s and L[t, s] = exp(acs_t - acs_s),
//     dx_s    = sum_{t >= s} M[t, s] dy_t + D dy_s + w_s Z_s    (w_s = exp(acs_end - acs_s) dt_s, Z = B dS),
//     dCB^T   [s, t] = sum over the group's heads of G[t, s] L[t, s] dt_s,
//     u_s     = sum_t G[t, s] CB[t, s] L[t, s]        (ddt's intra-chunk part),
//     xz_s    = x_s . Z_s                               (the chunk state's part of ddt and of the decay),
//     ai_s    = exp(acs_s) dy_s . (C_s . state)        (the entering state's part of the decay),
//     col_t   = sum_s G[t, s] M[t, s]                   (the decay's partial by row t, per s tile),
//     and each warp's part of sum dy . x (dD).
//   ssd_scale_kernel: x (or dy) times an f32 scale a step and head, rounded once to bf16, into the padded,
//     contiguous layout the cuBLAS steps take (each chunk's state from x exp(acs_end - acs) dt, the
//     entering states' gradients from dy exp(acs));
//   ssd_state_fwd_kernel, ssd_state_bwd_kernel: the states passed from chunk to chunk, state_{c+1} =
//     exp(T_c) state_c + S_c from state_0 = 0 (f32 in registers, each entering state stored in bf16), and
//     its gradient back from the last chunk, with each warp's part of dT_c = exp(T_c) dstate_{c+1} . state_c.
//
// Products run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators); the mask is made
// in registers from the chunk's acs and dt in shared memory, M rounded once to bf16 as an operand. No
// [heads, chunk, chunk] tensor reaches device memory: M, G and d(CB) per head live in registers, and the
// head sum of d(CB) in shared memory.
//
// Layout: a block takes one (batch, chunk, group) and a tile of 32 rows of the chunk (t in the forward, s
// in the backward), and walks the group's heads in turn, the next head's rows loaded by cp.async while
// the current one computes. The forward keeps the tile's CB rows and C rows, the backward the tile's CB^T
// rows and its d(CB)^T sums, for all heads. 8 warps: two of 16 rows each times four that split the
// product's depth (forward: the state's N, then the steps s <= t in 16-step units) or its width (backward:
// the steps t >= s in 16-step units); each of the four writes its partial sums to a slice of shared memory
// of its own, which the epilogue adds: no atomics, and a second launch repeats the first bit for bit.
//
// Bound: bytes (ops/ssd.py, bench_port/yardstick/bounds_ssd.py). At 8 x 16,384 tokens, 64 heads of 64 and
// N 128 the forward's products are 0.42 TFLOP, its bytes (x and y, B, C, dt) 2.25 GB, 0.67 ms at 3.35 TB/s;
// the states and C B^T these kernels read come from ops/ssd.py's steps in front of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int P = 64;          // head dim
constexpr int TILE = 32;       // rows of a block's tile
constexpr int MAX_Q = 256;     // longest chunk
constexpr int MAX_N = 128;     // largest state
constexpr int THREADS = 256;
constexpr int XS = P + 8;      // a bf16 row of x or dy in shared memory, padded (144 bytes: ldmatrix rows apart)
constexpr int NS = MAX_N + 8;  // a bf16 row of C or the state, padded (272 bytes)
constexpr int FS = MAX_Q + 8;  // an f32 row of CB, padded (1,056 bytes)
constexpr int YS = P + 8;      // an f32 row of a warp's partial y or dx, padded (288 bytes)
constexpr int SPLIT = 4;       // warps that split one row tile's product, each writing its partial sums

constexpr int FWD_BUF = MAX_Q * XS * 2 + P * NS * 2 + 2 * MAX_Q * 4;  // x rows, the state, acs, dt
constexpr int FWD_SMEM = TILE * FS * 4 + TILE * NS * 2 + 2 * FWD_BUF + SPLIT * TILE * YS * 4;
constexpr int BWD_BUF = MAX_Q * XS * 2 + TILE * XS * 2 + 2 * MAX_Q * 4;  // dy rows, x rows, acs, dt
constexpr int BWD_SMEM = 2 * TILE * FS * 4 + 2 * BWD_BUF + SPLIT * TILE * YS * 4 + SPLIT * TILE * 4 + 2 * MAX_Q * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b: a 16 x 16 bf16 (rows g, g + 8; columns 2q, 2q + 1 and + 8), b 16 x 8 (rows 2q, 2q + 1 and + 8;
// column g), d 16 x 8 f32 (rows g, g + 8; columns 2q, 2q + 1), g = lane / 4, q = lane % 4.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: lane l gives the address of row l % 8 of matrix l / 8. For a
// row-major [k][n] tile read as an mma b operand: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15) give b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
__device__ __forceinline__ void ldsm_t4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// M[t, s], M[t, s + 1] as an mma operand pair: CB times the decay times dt_s, 0 above the diagonal.
__device__ __forceinline__ uint32_t m_pair(const float* cb_row, float acs_t, int t, int s, const float* acs,
                                           const float* dt) {
  const float2 cb = *reinterpret_cast<const float2*>(cb_row + s);
  const float m0 = s <= t ? cb.x * __expf(acs_t - acs[s]) * dt[s] : 0.f;
  const float m1 = s + 1 <= t ? cb.y * __expf(acs_t - acs[s + 1]) * dt[s + 1] : 0.f;
  return pack(m0, m1);
}

struct FwdArgs {
  const bf16* x;        // [Bsz, L, H, P], x[b, l, h, p] at b * x_sb + l * x_sl + h * P + p
  long long x_sb, x_sl;
  const bf16* c;        // [Bsz, nc, G, Q, N], zero rows past L
  const float* dt;      // [Bsz, H, nc * Q], zero past L
  const float* acs;     // [Bsz, H, nc * Q], cumulative within each chunk
  const float* cb;      // [Bsz, nc, G, Q (t), Q (s)]
  const bf16* hs;       // [Bsz, nc, H, P, N], the state entering each chunk
  const float* D;       // [H]
  bf16* y;              // [Bsz, L, H, P]
  int L, H, G, N, Q, nc;
};

__global__ void __launch_bounds__(THREADS, 1) ssd_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cbs = reinterpret_cast<float*>(smem);                     // [TILE][FS]: CB rows t0.., columns < rows
  bf16* cs = reinterpret_cast<bf16*>(cbs + TILE * FS);             // [TILE][NS]: C rows t0..
  unsigned char* bufs = reinterpret_cast<unsigned char*>(cs + TILE * NS);
  float* ys = reinterpret_cast<float*>(bufs + 2 * FWD_BUF);         // [SPLIT][TILE][YS]: each warp's partial y

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, c = blockIdx.y / a.G, g = blockIdx.y % a.G, b = blockIdx.z;
  const int Q = a.Q, N = a.N, hg = a.H / a.G;
  const int t0 = j * TILE, rows = t0 + TILE;  // x rows [0, rows) reach the tile
  const long long lp = static_cast<long long>(a.nc) * Q;
  const long long cg = (static_cast<long long>(b) * a.nc + c) * a.G + g;

  {
    const float* src = a.cb + cg * Q * Q + static_cast<long long>(t0) * Q;
    const int per = rows / 4;
    for (int i = tid; i < TILE * per; i += THREADS) {
      const int r = i / per, k = (i % per) * 4;
      cp_async16(cbs + r * FS + k, src + static_cast<long long>(r) * Q + k, true);
    }
    const bf16* csrc = a.c + (cg * Q + t0) * N;
    const int pn = N / 8;
    for (int i = tid; i < TILE * pn; i += THREADS) {
      const int r = i / pn, k = (i % pn) * 8;
      cp_async16(cs + r * NS + k, csrc + static_cast<long long>(r) * N + k, true);
    }
  }
  auto load_head = [&](int hi, int buf) {
    const int h = g * hg + hi;
    bf16* xs = reinterpret_cast<bf16*>(bufs + buf * FWD_BUF);
    bf16* hsm = xs + MAX_Q * XS;
    float* as = reinterpret_cast<float*>(hsm + P * NS);
    float* ds = as + MAX_Q;
    for (int i = tid; i < rows * (P / 8); i += THREADS) {
      const int r = i >> 3, k = (i & 7) * 8;
      const long long l = static_cast<long long>(c) * Q + r;
      const bool ok = l < a.L;
      cp_async16(xs + r * XS + k, ok ? a.x + b * a.x_sb + l * a.x_sl + h * P + k : a.x, ok);
    }
    const bf16* hsrc = a.hs + ((static_cast<long long>(b) * a.nc + c) * a.H + h) * P * N;
    const int pn = N / 8;
    for (int i = tid; i < P * pn; i += THREADS) {
      const int r = i / pn, k = (i % pn) * 8;
      cp_async16(hsm + r * NS + k, hsrc + r * N + k, true);
    }
    const long long off = (static_cast<long long>(b) * a.H + h) * lp + static_cast<long long>(c) * Q;
    for (int i = tid; i < Q / 4; i += THREADS) {
      cp_async16(as + 4 * i, a.acs + off + 4 * i, true);
      cp_async16(ds + 4 * i, a.dt + off + 4 * i, true);
    }
  };
  load_head(0, 0);
  cp_async_commit();

  const int mi = warp & 1, k4 = warp >> 1, g8 = lane >> 2, q = lane & 3;
  const int r_lo = mi * 16 + g8, t_lo = t0 + r_lo;  // this thread's rows: r_lo and r_lo + 8 of the tile
  const int n_units = (t0 + mi * 16) / 16 + 1;      // 16-step units of s that reach the warp's rows

  for (int hi = 0; hi < hg; ++hi) {
    const int buf = hi & 1;
    if (hi + 1 < hg) {
      load_head(hi + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* xs = reinterpret_cast<const bf16*>(bufs + buf * FWD_BUF);
    const bf16* hsm = xs + MAX_Q * XS;
    const float* as = reinterpret_cast<const float*>(hsm + P * NS);
    const float* ds = as + MAX_Q;

    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    // the entering state: C_t . state over this warp's share of N
    for (int kk = k4; kk < N / 16; kk += 4) {
      const bf16* cp0 = cs + r_lo * NS + kk * 16 + 2 * q;
      const uint32_t af[4] = {ld32(cp0), ld32(cp0 + 8 * NS), ld32(cp0 + 8), ld32(cp0 + 8 * NS + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* hp = hsm + (nt * 8 + g8) * NS + kk * 16 + 2 * q;
        mma(acc[nt], af, ld32(hp), ld32(hp + 8));
      }
    }
    const float a_lo = as[t_lo], a_hi = as[t_lo + 8];
    {
      const float e_lo = __expf(a_lo), e_hi = __expf(a_hi);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= e_lo;
        acc[nt][1] *= e_lo;
        acc[nt][2] *= e_hi;
        acc[nt][3] *= e_hi;
      }
    }
    // the chunk's own steps: M x over this warp's units of s
    const float* cb_lo = cbs + r_lo * FS;
    const float* cb_hi = cb_lo + 8 * FS;
    for (int u = k4; u < n_units; u += 4) {
      const int s = u * 16 + 2 * q;
      const uint32_t af[4] = {m_pair(cb_lo, a_lo, t_lo, s, as, ds), m_pair(cb_hi, a_hi, t_lo + 8, s, as, ds),
                              m_pair(cb_lo, a_lo, t_lo, s + 8, as, ds),
                              m_pair(cb_hi, a_hi, t_lo + 8, s + 8, as, ds)};
      const bf16* xrow = xs + (u * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * XS + (lane >> 4) * 8;
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t r[4];
        ldsm_t4(r, xrow + n2 * 16);
        mma(acc[2 * n2], af, r[0], r[1]);
        mma(acc[2 * n2 + 1], af, r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* y0 = ys + (k4 * TILE + r_lo) * YS + nt * 8 + 2 * q;
      *reinterpret_cast<float2*>(y0) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(y0 + 8 * YS) = make_float2(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
    {
      // 8 channels of one row a thread: the four partial sums, the D skip, one rounding, one 16-byte store
      const int r = tid >> 3, p0 = (tid & 7) * 8, h = g * hg + hi;
      const long long l = static_cast<long long>(c) * Q + t0 + r;
      if (l < a.L) {
        const float d = a.D[h];
        const bf16* xr = xs + (t0 + r) * XS + p0;
        alignas(16) bf16 out[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = d * __bfloat162float(xr[i]);
#pragma unroll
          for (int k = 0; k < SPLIT; ++k) v += ys[(k * TILE + r) * YS + p0 + i];
          out[i] = __float2bfloat16_rn(v);
        }
        *reinterpret_cast<uint4*>(a.y + ((static_cast<long long>(b) * a.L + l) * a.H + h) * P + p0) =
            *reinterpret_cast<const uint4*>(out);
      }
    }
    __syncthreads();
  }
}

struct BwdArgs {
  const bf16* x;        // as the forward's
  long long x_sb, x_sl;
  const bf16* dy;       // [Bsz, L, H, P]
  const bf16* z;        // [Bsz, nc, G, Q, H / G, P]: B . dS, zero rows past L
  const bf16* yi;       // like z: C . state, the entering state's output before exp(acs)
  const float* dt;      // [Bsz, H, nc * Q]
  const float* acs;     // [Bsz, H, nc * Q]
  const float* cbt;     // [Bsz, nc, G, Q (s), Q (t)]: CB^T
  const float* D;       // [H]
  bf16* dx;             // [Bsz, L, H, P]
  float* dcbt;          // [Bsz, nc, G, Q (s), Q (t)]: d(CB)^T summed over the group's heads
  float* u;             // [Bsz, H, nc * Q]
  float* xz;            // [Bsz, H, nc * Q]
  float* ai;            // [Bsz, H, nc * Q]
  float* col;           // [Q / TILE, Bsz, H, nc * Q]: each s tile's column sums
  float* dd;            // [Bsz, nc, Q / TILE, H, 8]: each warp's sum of dy . x
  int Bsz, L, H, G, Q, nc;
};

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cbts = reinterpret_cast<float*>(smem);   // [TILE][FS]: CB^T rows s0.., columns >= s0
  float* dcbs = cbts + TILE * FS;                 // [TILE][FS]: d(CB)^T over the heads
  unsigned char* bufs = reinterpret_cast<unsigned char*>(dcbs + TILE * FS);
  float* dxs = reinterpret_cast<float*>(bufs + 2 * BWD_BUF);  // [SPLIT][TILE][YS]: each warp's partial dx
  float* us = dxs + SPLIT * TILE * YS;                          // [SPLIT][TILE]: each warp's partial u
  float* cols = us + SPLIT * TILE;                              // [2][MAX_Q]: each row half's column sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x, c = blockIdx.y / a.G, g = blockIdx.y % a.G, b = blockIdx.z;
  const int Q = a.Q, hg = a.H / a.G, ntile = Q / TILE;
  const int s0 = j * TILE;  // the tile's steps s0 .. s0 + TILE - 1 see the steps t >= s0
  const long long lp = static_cast<long long>(a.nc) * Q;
  const long long chunk = static_cast<long long>(b) * a.nc + c;
  const long long cg = chunk * a.G + g;

  {
    const float* src = a.cbt + cg * Q * Q + static_cast<long long>(s0) * Q;
    const int per = (Q - s0) / 4;
    for (int i = tid; i < TILE * per; i += THREADS) {
      const int r = i / per, k = s0 + (i % per) * 4;
      cp_async16(cbts + r * FS + k, src + static_cast<long long>(r) * Q + k, true);
    }
  }
  auto load_head = [&](int hi, int buf) {
    const int h = g * hg + hi;
    bf16* dys = reinterpret_cast<bf16*>(bufs + buf * BWD_BUF);
    bf16* xs = dys + MAX_Q * XS;
    float* as = reinterpret_cast<float*>(xs + TILE * XS);
    float* ds = as + MAX_Q;
    for (int i = tid; i < (Q - s0) * (P / 8); i += THREADS) {
      const int r = s0 + (i >> 3), k = (i & 7) * 8;
      const long long l = static_cast<long long>(c) * Q + r;
      const bool ok = l < a.L;
      cp_async16(dys + r * XS + k, ok ? a.dy + ((static_cast<long long>(b) * a.L + l) * a.H + h) * P + k : a.dy, ok);
    }
    for (int i = tid; i < TILE * (P / 8); i += THREADS) {
      const int r = i >> 3, k = (i & 7) * 8;
      const long long l = static_cast<long long>(c) * Q + s0 + r;
      const bool ok = l < a.L;
      cp_async16(xs + r * XS + k, ok ? a.x + b * a.x_sb + l * a.x_sl + h * P + k : a.x, ok);
    }
    const long long off = (static_cast<long long>(b) * a.H + h) * lp + static_cast<long long>(c) * Q;
    for (int i = tid; i < Q / 4; i += THREADS) {
      cp_async16(as + 4 * i, a.acs + off + 4 * i, true);
      cp_async16(ds + 4 * i, a.dt + off + 4 * i, true);
    }
  };
  load_head(0, 0);
  cp_async_commit();
  for (int i = tid; i < TILE * FS; i += THREADS) dcbs[i] = 0.f;
  for (int i = tid; i < 2 * MAX_Q; i += THREADS) cols[i] = 0.f;

  const int mi = warp & 1, k4 = warp >> 1, g8 = lane >> 2, q = lane & 3;
  const int r_lo = mi * 16 + g8, s_lo = s0 + r_lo;  // this thread's rows: r_lo and r_lo + 8 of the tile
  const int u_begin = (s0 + mi * 16) / 16, n_u = Q / 16;
  float* dc_lo = dcbs + r_lo * FS;
  float* dc_hi = dc_lo + 8 * FS;
  const float* cb_lo = cbts + r_lo * FS;
  const float* cb_hi = cb_lo + 8 * FS;

  for (int hi = 0; hi < hg; ++hi) {
    const int buf = hi & 1, h = g * hg + hi;
    if (hi + 1 < hg) {
      load_head(hi + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* dys = reinterpret_cast<const bf16*>(bufs + buf * BWD_BUF);
    const bf16* xs = dys + MAX_Q * XS;
    const float* as = reinterpret_cast<const float*>(xs + TILE * XS);
    const float* ds = as + MAX_Q;

    uint32_t xa[4][4];  // x of rows r_lo, r_lo + 8 as the a operand over p
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* xp = xs + r_lo * XS + kk * 16 + 2 * q;
      xa[kk][0] = ld32(xp);
      xa[kk][1] = ld32(xp + 8 * XS);
      xa[kk][2] = ld32(xp + 8);
      xa[kk][3] = ld32(xp + 8 * XS + 8);
    }
    const float a_lo = as[s_lo], a_hi = as[s_lo + 8], d_lo = ds[s_lo], d_hi = ds[s_lo + 8];
    float dxa[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dxa[nt][0] = dxa[nt][1] = dxa[nt][2] = dxa[nt][3] = 0.f;
    float u_lo = 0.f, u_hi = 0.f;

    for (int uu = u_begin + k4; uu < n_u; uu += 4) {
      const int tb = uu * 16;
      float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // G^T[s, t] = x_s . dy_t
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* dp = dys + (tb + nt * 8 + g8) * XS + kk * 16 + 2 * q;
          mma(gt[nt], xa[kk], ld32(dp), ld32(dp + 8));
        }
      }
      float mt[2][4];  // M^T[s, t]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int t = tb + nt * 8 + 2 * q;
        const float at0 = as[t], at1 = as[t + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = half ? s_lo + 8 : s_lo;
          const float a_s = half ? a_hi : a_lo, d_s = half ? d_hi : d_lo;
          const float2 cb = *reinterpret_cast<const float2*>((half ? cb_hi : cb_lo) + t);
          const float l0 = s <= t ? __expf(at0 - a_s) : 0.f;
          const float l1 = s <= t + 1 ? __expf(at1 - a_s) : 0.f;
          const float g0 = gt[nt][2 * half] * l0, g1 = gt[nt][2 * half + 1] * l1;
          float2* dc = reinterpret_cast<float2*>((half ? dc_hi : dc_lo) + t);
          float2 v = *dc;
          v.x += g0 * d_s;
          v.y += g1 * d_s;
          *dc = v;
          if (half) u_hi += g0 * cb.x + g1 * cb.y;
          else u_lo += g0 * cb.x + g1 * cb.y;
          mt[nt][2 * half] = cb.x * l0 * d_s;
          mt[nt][2 * half + 1] = cb.y * l1 * d_s;
        }
      }
      // the decay's partial by t: sum over this tile's s of G M
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          float v = gt[nt][par] * mt[nt][par] + gt[nt][2 + par] * mt[nt][2 + par];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g8 == 0) cols[mi * MAX_Q + tb + nt * 8 + 2 * q + par] += v;  // t is this warp's alone
        }
      }
      // dx_s += sum_t M^T[s, t] dy_t
      const uint32_t ma[4] = {pack(mt[0][0], mt[0][1]), pack(mt[0][2], mt[0][3]), pack(mt[1][0], mt[1][1]),
                              pack(mt[1][2], mt[1][3])};
      const bf16* dyrow = dys + (tb + ((lane >> 3) & 1) * 8 + (lane & 7)) * XS + (lane >> 4) * 8;
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t r[4];
        ldsm_t4(r, dyrow + n2 * 16);
        mma(dxa[2 * n2], ma, r[0], r[1]);
        mma(dxa[2 * n2 + 1], ma, r[2], r[3]);
      }
    }
    u_lo += __shfl_xor_sync(0xffffffffu, u_lo, 1);
    u_lo += __shfl_xor_sync(0xffffffffu, u_lo, 2);
    u_hi += __shfl_xor_sync(0xffffffffu, u_hi, 1);
    u_hi += __shfl_xor_sync(0xffffffffu, u_hi, 2);
    if (q == 0) {
      us[k4 * TILE + r_lo] = u_lo;
      us[k4 * TILE + r_lo + 8] = u_hi;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* d0 = dxs + (k4 * TILE + r_lo) * YS + nt * 8 + 2 * q;
      *reinterpret_cast<float2*>(d0) = make_float2(dxa[nt][0], dxa[nt][1]);
      *reinterpret_cast<float2*>(d0 + 8 * YS) = make_float2(dxa[nt][2], dxa[nt][3]);
    }
    __syncthreads();
    {
      // 8 channels of one step a thread: the D skip and the chunk state's term, one rounding
      const int r = tid >> 3, p0 = (tid & 7) * 8, s = s0 + r;
      const long long l = static_cast<long long>(c) * Q + s;
      const float w = __expf(as[Q - 1] - as[s]) * ds[s], dh = a.D[h];
      const bf16* dyr = dys + s * XS + p0;
      const bf16* xr = xs + r * XS + p0;
      const long long zo = ((cg * Q + s) * hg + hi) * P + p0;
      const uint4 zz = *reinterpret_cast<const uint4*>(a.z + zo), yy = *reinterpret_cast<const uint4*>(a.yi + zo);
      const bf16* zb = reinterpret_cast<const bf16*>(&zz);
      const bf16* yb = reinterpret_cast<const bf16*>(&yy);
      alignas(16) bf16 out[8];
      float xzp = 0.f, aip = 0.f, ddp = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dyv = __bfloat162float(dyr[i]), xv = __bfloat162float(xr[i]), zv = __bfloat162float(zb[i]);
        aip += dyv * __bfloat162float(yb[i]);
        float v = dh * dyv + w * zv;
#pragma unroll
        for (int k = 0; k < SPLIT; ++k) v += dxs[(k * TILE + r) * YS + p0 + i];
        out[i] = __float2bfloat16_rn(v);
        xzp += xv * zv;
        ddp += dyv * xv;
      }
      if (l < a.L)
        *reinterpret_cast<uint4*>(a.dx + ((static_cast<long long>(b) * a.L + l) * a.H + h) * P + p0) =
            *reinterpret_cast<const uint4*>(out);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        xzp += __shfl_xor_sync(0xffffffffu, xzp, o);
        aip += __shfl_xor_sync(0xffffffffu, aip, o);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ddp += __shfl_xor_sync(0xffffffffu, ddp, o);
      if ((tid & 7) == 0) {
        const long long o = (static_cast<long long>(b) * a.H + h) * lp + static_cast<long long>(c) * Q + s;
        a.xz[o] = xzp;
        a.ai[o] = __expf(as[s]) * aip;
        a.u[o] = us[r] + us[TILE + r] + us[2 * TILE + r] + us[3 * TILE + r];
      }
      if (lane == 0) a.dd[((chunk * ntile + j) * a.H + h) * 8 + warp] = ddp;
      const long long o = ((static_cast<long long>(j) * a.Bsz + b) * a.H + h) * lp + static_cast<long long>(c) * Q;
      for (int t = tid; t < Q; t += THREADS) {
        a.col[o + t] = cols[t] + cols[MAX_Q + t];
        cols[t] = cols[MAX_Q + t] = 0.f;
      }
    }
    __syncthreads();
  }
  float* dst = a.dcbt + cg * Q * Q + static_cast<long long>(s0) * Q;
  for (int i = tid; i < TILE * Q; i += THREADS) {
    const int r = i / Q, t = i % Q;
    dst[static_cast<long long>(r) * Q + t] = dcbs[r * FS + t];
  }
}

// out[b, l, h, :] = x[b, l, h, :] * scale[b, h, l] in f32, rounded once to bf16, for l < L, and 0 for
// L <= l < Lp: out contiguous [Bsz, Lp, H, P], 8 channels (16 bytes) a thread.
__global__ void __launch_bounds__(256) ssd_scale_kernel(const bf16* __restrict__ x, long long x_sb, long long x_sl,
                                                        const float* __restrict__ scale, bf16* __restrict__ out,
                                                        int L, int Lp, int H, long long n) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += static_cast<long long>(gridDim.x) * 256) {
    const int p0 = static_cast<int>(i % (P / 8)) * 8;
    const long long row = i / (P / 8);  // (b, l, h)
    const int h = static_cast<int>(row % H);
    const long long bl = row / H;
    const int l = static_cast<int>(bl % Lp);
    const long long b = bl / Lp;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (l < L) {
      const float sc = scale[(b * H + h) * Lp + l];
      const uint4 v = *reinterpret_cast<const uint4*>(x + b * x_sb + l * x_sl + h * P + p0);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      alignas(16) bf16 w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = __float2bfloat16_rn(__bfloat162float(e[k]) * sc);
      o = *reinterpret_cast<const uint4*>(w);
    }
    *reinterpret_cast<uint4*>(out + i * 8) = o;
  }
}

// The states between chunks, forward: thread i keeps 4 of the P x N entries of one (batch, head) in f32
// through the chunks, storing each entering state rounded to bf16.
__global__ void __launch_bounds__(256) ssd_state_fwd_kernel(const float* __restrict__ S, const float* __restrict__ decay,
                                                            bf16* __restrict__ hs, int nc, int H, int PN) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4, h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const long long o = ((static_cast<long long>(b) * nc + c) * H + h) * PN + e;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(st.x, st.y), hi = __floats2bfloat162_rn(st.z, st.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(hs + o) = packed;
    const float d = decay[(static_cast<long long>(b) * nc + c) * H + h];
    const float4 sc = *reinterpret_cast<const float4*>(S + o);
    st = make_float4(fmaf(d, st.x, sc.x), fmaf(d, st.y, sc.y), fmaf(d, st.z, sc.z), fmaf(d, st.w, sc.w));
  }
}

// The states between chunks, backward: thread i keeps 8 entries of one (batch, head) of the gradient of the
// state leaving chunk c, g, from the last chunk back: dS_c = g (stored in bf16), each warp's part of
// exp(T_c) g . state_c into dT_part[b, c, h, warp of the grid row], then g = dstate_c + exp(T_c) g.
__global__ void __launch_bounds__(256) ssd_state_bwd_kernel(const float* __restrict__ dstate,
                                                            const bf16* __restrict__ hs,
                                                            const float* __restrict__ decay, bf16* __restrict__ dS,
                                                            float* __restrict__ dT_part, int nc, int H, int PN) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 8, h = blockIdx.y, b = blockIdx.z;
  const int parts = gridDim.x * 8, part = blockIdx.x * 8 + (threadIdx.x >> 5);
  const bool in = e < PN;
  float g[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = nc - 1; c >= 0; --c) {
    const long long o = ((static_cast<long long>(b) * nc + c) * H + h) * PN + e;
    const float d = decay[(static_cast<long long>(b) * nc + c) * H + h];
    float dot = 0.f;
    if (in) {
      alignas(16) bf16 out[8];
      const uint4 hv = *reinterpret_cast<const uint4*>(hs + o);
      const bf16* hb = reinterpret_cast<const bf16*>(&hv);
      const float4 d0 = *reinterpret_cast<const float4*>(dstate + o), d1 = *reinterpret_cast<const float4*>(dstate + o + 4);
      const float ds[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        out[i] = __float2bfloat16_rn(g[i]);
        dot += g[i] * __bfloat162float(hb[i]);
        g[i] = fmaf(d, g[i], ds[i]);
      }
      *reinterpret_cast<uint4*>(dS + o) = *reinterpret_cast<const uint4*>(out);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if ((threadIdx.x & 31) == 0)
      dT_part[((static_cast<long long>(b) * nc + c) * H + h) * parts + part] = d * dot;
  }
}

int check_shape(int Bsz, int L, int H, int G, int N, int Q, int nc) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || Q % TILE || Q <= 0 || Q > MAX_Q || N % 16 || N <= 0 ||
      N > MAX_N || nc != (L + Q - 1) / Q || static_cast<long long>(nc) * G > 65535 || Bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// x: bf16 [Bsz, L, H, 64] at the given batch and row strides (elements; multiples of 8, the pointer 16-byte
// aligned); every other tensor contiguous in the layout of FwdArgs / BwdArgs. The chunk Q is a multiple of 32
// up to 256, N a multiple of 16 up to 128.
int mlpt_ssd_fwd(const void* x, long long x_sb, long long x_sl, const void* c, const void* dt, const void* acs,
                 const void* cb, const void* hs, const void* D, void* y, int Bsz, int L, int H, int G, int N, int Q,
                 void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  const int nc = (L + Q - 1) / Q;
  if (int err = check_shape(Bsz, L, H, G, N, Q, nc)) return err;
  cudaError_t e = cudaFuncSetAttribute(ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  FwdArgs a{static_cast<const bf16*>(x), x_sb, x_sl, static_cast<const bf16*>(c), static_cast<const float*>(dt),
            static_cast<const float*>(acs), static_cast<const float*>(cb), static_cast<const bf16*>(hs),
            static_cast<const float*>(D), static_cast<bf16*>(y), L, H, G, N, Q, nc};
  ssd_fwd_kernel<<<dim3(Q / TILE, nc * G, Bsz), THREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int mlpt_ssd_bwd(const void* x, long long x_sb, long long x_sl, const void* dy, const void* z, const void* yi,
                 const void* dt, const void* acs, const void* cbt, const void* D, void* dx, void* dcbt, void* u,
                 void* xz, void* ai, void* col, void* dd, int Bsz, int L, int H, int G, int Q, void* stream) {
  (void)cudaGetLastError();
  const int nc = (L + Q - 1) / Q;
  if (int err = check_shape(Bsz, L, H, G, 16, Q, nc)) return err;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  BwdArgs a{static_cast<const bf16*>(x), x_sb, x_sl, static_cast<const bf16*>(dy), static_cast<const bf16*>(z),
            static_cast<const bf16*>(yi), static_cast<const float*>(dt), static_cast<const float*>(acs),
            static_cast<const float*>(cbt), static_cast<const float*>(D), static_cast<bf16*>(dx),
            static_cast<float*>(dcbt), static_cast<float*>(u), static_cast<float*>(xz), static_cast<float*>(ai),
            static_cast<float*>(col), static_cast<float*>(dd), Bsz, L, H, G, Q, nc};
  ssd_bwd_kernel<<<dim3(Q / TILE, nc * G, Bsz), THREADS, BWD_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// x as for mlpt_ssd_fwd, scale [Bsz, H, Lp] f32, out [Bsz, Lp, H, 64] bf16 (Lp >= L).
int mlpt_ssd_scale(const void* x, long long x_sb, long long x_sl, const void* scale, void* out, int Bsz, int L, int Lp,
                   int H, void* stream) {
  (void)cudaGetLastError();
  if (Bsz <= 0 || L <= 0 || Lp < L || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(Bsz) * Lp * H * (P / 8);
  const long long blocks = (n + 255) / 256;
  ssd_scale_kernel<<<static_cast<unsigned>(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x), x_sb, x_sl,
                                                          static_cast<const float*>(scale), static_cast<bf16*>(out),
                                                          L, Lp, H, n);
  return static_cast<int>(cudaGetLastError());
}

// S, hs: [Bsz, nc, H, PN] (f32, bf16), decay [Bsz, nc, H] f32; PN a multiple of 8.
int mlpt_ssd_state_fwd(const void* S, const void* decay, void* hs, int Bsz, int nc, int H, int PN, void* stream) {
  (void)cudaGetLastError();
  if (Bsz <= 0 || Bsz > 65535 || nc <= 0 || H <= 0 || H > 65535 || PN <= 0 || PN % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_state_fwd_kernel<<<dim3((PN / 4 + 255) / 256, H, Bsz), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(decay), static_cast<bf16*>(hs), nc, H, PN);
  return static_cast<int>(cudaGetLastError());
}

// The number of dT partials ssd_state_bwd writes for each (batch, chunk, head).
int mlpt_ssd_state_bwd_parts(int PN) { return ((PN / 8 + 255) / 256) * 8; }

// dstate [Bsz, nc, H, PN] f32, hs and dS [Bsz, nc, H, PN] bf16, decay [Bsz, nc, H] f32,
// dT_part [Bsz, nc, H, mlpt_ssd_state_bwd_parts(PN)] f32.
int mlpt_ssd_state_bwd(const void* dstate, const void* hs, const void* decay, void* dS, void* dT_part, int Bsz,
                       int nc, int H, int PN, void* stream) {
  (void)cudaGetLastError();
  if (Bsz <= 0 || Bsz > 65535 || nc <= 0 || H <= 0 || H > 65535 || PN <= 0 || PN % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_state_bwd_kernel<<<dim3((PN / 8 + 255) / 256, H, Bsz), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dstate), static_cast<const bf16*>(hs), static_cast<const float*>(decay),
      static_cast<bf16*>(dS), static_cast<float*>(dT_part), nc, H, PN);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
