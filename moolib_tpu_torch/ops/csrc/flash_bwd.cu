// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of moolib_tpu/ops/flash_attention.py
// launched by `_flash_backward`:
//   - `_flash_bwd_dq_kernel` (:249, launched at :399) -> flash_bwd_dq_kernel;
//   - `_flash_bwd_dkv_kernel` (:296, launched at :417) -> the dk/dv pass,
//     flash_bwd_dkv_wgmma_kernel in bfloat16, flash_bwd_dkv_kernel in float32.
// FlashAttention-2 math, scale D**-0.5, per attended (query i, key j) pair:
//   p    = exp(s - lse_i),  s = q_i . k_j * scale  (masked pairs: p = 0)
//   dp   = dO_i . v_j
//   ds   = p * (dp - delta_i) * scale,  delta_i = rowsum(dO_i * O_i) - g_lse_i
//   dq_i += ds k_j,   dk_j += ds q_i,   dv_j += p dO_i
// `lse` comes straight from flash_fwd and `delta` is computed by the caller,
// as the JAX package computes it outside Pallas.  Accumulation is f32.
//
// Layout: q, dO [B, Tq, H, D]; k, v [B, Tk, H, D] (contiguous); lse, delta
// [B, Tq, H] f32; dq in q's dtype, dk/dv in k's.  Any T >= 1: tail tiles are
// masked.  Tiles wholly above the diagonal are skipped under causal.
//
// Two passes and no atomics, as on the TPU: the dq pass owns a query tile
// and sweeps K/V, the dk/dv pass owns a K/V tile and sweeps Q/dO.  Every
// gradient element has one writer and a fixed summation order, so results
// are bitwise reproducible run to run.
//
// What bounds it on the card.  At the training shape (16, 1024, 8, 128) bf16
// causal the dq pass does 6 D and the dk/dv pass 8 D operations per attended
// pair against ~5 and ~6 [B, T, H, D] tensors of traffic: both are bound by
// the tensor cores' arithmetic (989 TFLOP/s bf16 dense).
//
// dk/dv pass in bfloat16: flash_bwd_dkv_wgmma_kernel, on the tensor cores.
//   - One CTA of one warpgroup (128 threads) per (batch * head, 64-key
//     tile), two CTAs an SM.  K and V stay in shared memory; 64-query Q and
//     dO tiles, with their rows of lse and delta, stream through a ring of
//     two stages filled by cp.async while the warpgroup computes on the
//     other.  Tiles stay bf16 in the 128-byte swizzled layout of hopper.cuh.
//     Under causal the first key tiles, which see the most queries, launch
//     first.
//   - The TPU kernel's transposed scores: S^T = K Q^T and dP^T = V dO^T
//     are two wgmma m64n64k16 chains (all operands K-major from shared
//     memory) into f32 registers.  P^T = exp(S^T - lse) and
//     dS^T = P^T (dP^T - delta) scale are formed in f32 on that fragment.
//   - P^T and dS^T are rounded to bf16 (the TPU kernel's casts, :323-335)
//     and are already the register A operands of dV += P^T dO and
//     dK += dS^T Q; dO and Q are read MN-major through the descriptor's
//     transpose bit, one m64n64k16 per 64-column panel.  The two [64, D] f32
//     accumulators stay in registers for the whole sweep.
//
// dq pass (both dtypes), and the dk/dv pass in float32: the CUDA-core design
// of the first port, unchanged.  A float32 product on the tensor cores would
// be TF32, too coarse for the float32 tolerances (1e-4).  The dq pass runs
// one CTA per (batch * head, 64-row query tile) sweeping 32-key K/V tiles;
// the dk/dv pass one CTA per (batch * head, 32-row key tile) sweeping 32-row
// Q/dO tiles.  Tiles are staged through shared memory as f32 (bf16 widened
// on load), 128 threads a CTA: thread (ty, tx) = (tid / 8, tid % 8) owns R
// consecutive tile rows (4 in the dq pass, 2 in the dk/dv pass) and the 4
// score columns tx + 8 j; its accumulators are the dims 4 tx + 32 c .. +3
// of its rows, and score tiles go through shared memory, read back only by
// the warp that wrote them.  The dq pass's redesign for the tensor cores is
// still to come.
//
// The dtype dispatch is in run(): a bfloat16 dk/dv call reaches only the
// tensor-core kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;  // 16 row groups x 8 lanes
constexpr int NCOL = 32;      // score columns per tile: tx + 8*j, j < 4
constexpr int PROW = NCOL + 4;  // score tile smem row stride (floats)

template <int D>
struct Row {
  static constexpr int ROW = D + 4;  // Q/K/V/dO smem row stride (floats)
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Stage rows [row0, row0 + ROWS) of one head into smem as f32; rows at or
// past T are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t b, int h,
                                          int row0, int T_len, int H) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 4;
    const int g = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < T_len) val = load4(src + ((b * T_len + g) * H + h) * D + c);
    store4(dst + r * Row<D>::ROW + c, val);
  }
}

// s[i][j] = A[row ty*R+i] . B[row tx+8*j] over D.
template <int D, int R>
__device__ __forceinline__ void tile_dots(const float* A, const float* B, int ty, int tx,
                                          float (&s)[R][4]) {
  constexpr int ROW = Row<D>::ROW;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[4];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = load4(A + (ty * R + i) * ROW + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = load4(B + (tx + 8 * j) * ROW + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = s[i][j];
        acc = fmaf(av[i].x, bv[j].x, acc);
        acc = fmaf(av[i].y, bv[j].y, acc);
        acc = fmaf(av[i].z, bv[j].z, acc);
        acc = fmaf(av[i].w, bv[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// acc[i][c][e] += sum_n P[row ty*R+i][n] * M[row n][4*tx + 32*c + e],
// n over the NCOL columns of the score tile.
template <int D, int R>
__device__ __forceinline__ void tile_accum(const float* P, const float* M, int ty, int tx,
                                           float (&acc)[R][D / 32][4]) {
  constexpr int ROW = Row<D>::ROW;
  constexpr int DC = D / 32;
#pragma unroll 2
  for (int n = 0; n < NCOL; n += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = load4(P + (ty * R + i) * PROW + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 mv = load4(M + (n + e) * ROW + tx * 4 + 32 * c);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = lane(pv[i], e);
          acc[i][c][0] = fmaf(p, mv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p, mv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p, mv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p, mv.w, acc[i][c][3]);
        }
      }
    }
  }
}

template <typename T, int D, int R>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[R][D / 32][4],
                                           int64_t b, int h, int row0, int T_len, int H,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + ty * R + i;
    if (r >= T_len) continue;
    const int64_t base = ((b * T_len + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      store4(out + base + tx * 4 + 32 * c,
             make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]));
  }
}

template <int D, int R>
__device__ __forceinline__ void zero(float (&acc)[R][D / 32][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
}

constexpr int DQ_R = 4;
constexpr int DQ_BQ = 16 * DQ_R;  // query rows per dq CTA
constexpr int DKV_R = 2;
constexpr int DKV_BK = 16 * DKV_R;  // key rows per dk/dv CTA

template <int D>
struct DqSmem {  // Q, dO (DQ_BQ rows), K, V (NCOL rows), dS
  static constexpr int BYTES =
      4 * (2 * DQ_BQ * Row<D>::ROW + 2 * NCOL * Row<D>::ROW + DQ_BQ * PROW);
};

template <int D>
struct DkvSmem {  // K, V (DKV_BK rows), Q, dO (NCOL rows), P, dS
  static constexpr int BYTES =
      4 * (2 * DKV_BK * Row<D>::ROW + 2 * NCOL * Row<D>::ROW + 2 * DKV_BK * PROW);
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Tq, int Tk, int H, float scale) {
  constexpr int ROW = Row<D>::ROW;
  constexpr int R = DQ_R;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + DQ_BQ * ROW;
  float* Ks = dOs + DQ_BQ * ROW;
  float* Vs = Ks + NCOL * ROW;
  float* Ss = Vs + NCOL * ROW;

  const int bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * DQ_BQ;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;

  load_tile<T, D, DQ_BQ>(Qs, q, b, h, q0, Tq, H);
  load_tile<T, D, DQ_BQ>(dOs, dout, b, h, q0, Tq, H);
  float lse_r[R], delta_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty * R + i;
    const int64_t row = (b * Tq + qp) * H + h;
    lse_r[i] = qp < Tq ? lse[row] : 0.f;
    delta_r[i] = qp < Tq ? delta[row] : 0.f;
  }
  float acc[R][D / 32][4];
  zero<D, R>(acc);

  // Causal: keys past the tile's last query row are masked for every row.
  const int kv_end = CAUSAL ? min(Tk, q0 + DQ_BQ) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += NCOL) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, NCOL>(Ks, k, b, h, k0, Tk, H);
    load_tile<T, D, NCOL>(Vs, v, b, h, k0, Tk, H);
    __syncthreads();

    float s[R][4], dp[R][4];
    tile_dots<D, R>(Qs, Ks, ty, tx, s);
    tile_dots<D, R>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool valid = qp < Tq && kp < Tk && (!CAUSAL || qp >= kp);
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        Ss[(ty * R + i) * PROW + tx + 8 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncwarp();  // dS rows of a row group are read only by its own warp
    tile_accum<D, R>(Ss, Ks, ty, tx, acc);  // dq += dS K
    __syncwarp();  // dS reads done before the next tile overwrites it
  }
  store_rows<T, D, R>(dq, acc, b, h, q0, Tq, H, ty, tx);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H,
                     float scale) {
  constexpr int ROW = Row<D>::ROW;
  constexpr int R = DKV_R;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + DKV_BK * ROW;
  float* Qs = Vs + DKV_BK * ROW;
  float* dOs = Qs + NCOL * ROW;
  float* Ps = dOs + NCOL * ROW;
  float* Ss = Ps + DKV_BK * PROW;

  const int bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * DKV_BK;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;

  load_tile<T, D, DKV_BK>(Ks, k, b, h, k0, Tk, H);
  load_tile<T, D, DKV_BK>(Vs, v, b, h, k0, Tk, H);
  float acc_dk[R][D / 32][4], acc_dv[R][D / 32][4];
  zero<D, R>(acc_dk);
  zero<D, R>(acc_dv);

  // Causal: queries before the tile's first key see none of its keys.
  const int q_begin = CAUSAL ? (k0 / NCOL) * NCOL : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += NCOL) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<T, D, NCOL>(Qs, q, b, h, q0, Tq, H);
    load_tile<T, D, NCOL>(dOs, dout, b, h, q0, Tq, H);
    __syncthreads();

    float lse_c[4], delta_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = q0 + tx + 8 * j;
      const int64_t row = (b * Tq + qp) * H + h;
      lse_c[j] = qp < Tq ? lse[row] : 0.f;
      delta_c[j] = qp < Tq ? delta[row] : 0.f;
    }
    float st[R][4], dpt[R][4];
    tile_dots<D, R>(Ks, Qs, ty, tx, st);   // scores transposed: [key, query]
    tile_dots<D, R>(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kp = k0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + tx + 8 * j;
        const bool valid = qp < Tq && kp < Tk && (!CAUSAL || qp >= kp);
        const float p = valid ? expf(st[i][j] * scale - lse_c[j]) : 0.f;
        Ps[(ty * R + i) * PROW + tx + 8 * j] = p;
        Ss[(ty * R + i) * PROW + tx + 8 * j] = p * (dpt[i][j] - delta_c[j]) * scale;
      }
    }
    __syncwarp();  // P/dS rows of a row group are read only by its own warp
    tile_accum<D, R>(Ps, dOs, ty, tx, acc_dv);  // dv += P^T dO
    tile_accum<D, R>(Ss, Qs, ty, tx, acc_dk);   // dk += dS^T Q
    __syncwarp();
  }
  store_rows<T, D, R>(dk, acc_dk, b, h, k0, Tk, H, ty, tx);
  store_rows<T, D, R>(dv, acc_dv, b, h, k0, Tk, H, ty, tx);
}

// ---- dk/dv pass, bfloat16: tensor cores --------------------------------

constexpr int TC_KEYS = 64;     // keys per CTA
constexpr int TC_QROWS = 64;    // queries per Q/dO tile
constexpr int TC_THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DkvTcSmem {  // K, V, then Q and dO of stages 0 and 1, then the row tables
  static constexpr int TILE = 64 * D * 2;  // one [64, D] bf16 tile
  static constexpr int ROWS = 2 * TC_QROWS * 4;  // lse and delta of one stage
  static constexpr int BYTES = 6 * TILE + 2 * ROWS + 1024;  // 1024 B to align
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Tq, int Tk, int H, float scale) {
  using namespace hopper;
  using S = DkvTcSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u, sV = sK + S::TILE;
  const uint8_t* rows_base = smem_raw + (sK - raw) + 6 * S::TILE;  // generic pointer

  const int64_t b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int k0 = blockIdx.y * TC_KEYS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = scale * LOG2E;

  // Causal: queries before the tile's first key see none of its keys.
  const int q_begin = CAUSAL ? k0 : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + TC_QROWS - 1) / TC_QROWS : 0;

  // Stage `stage` of the ring: Q, dO, and the tile's lse and delta rows.
  auto load_stage = [&](int stage, int i0) {
    const uint32_t sQ = sK + (2 + 2 * stage) * S::TILE;
    hopper::load_tile<TC_QROWS, D, TC_THREADS>(sQ, q, b, h, i0, Tq, H);
    hopper::load_tile<TC_QROWS, D, TC_THREADS>(sQ + S::TILE, dout, b, h, i0, Tq, H);
    const int r = tid % TC_QROWS;
    const bool valid = i0 + r < Tq;
    const int64_t row = (b * Tq + (valid ? i0 + r : 0)) * H + h;
    cp_async_4(sK + 6 * S::TILE + stage * S::ROWS + tid * 4, (tid < TC_QROWS ? lse : delta) + row,
               valid);
  };

  if (n_tiles > 0) {
    hopper::load_tile<TC_KEYS, D, TC_THREADS>(sK, k, b, h, k0, Tk, H);
    hopper::load_tile<TC_KEYS, D, TC_THREADS>(sV, v, b, h, k0, Tk, H);
    load_stage(0, q_begin);
    cp_async_commit();
  }

  float dk_acc[PANELS][32], dv_acc[PANELS][32];
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int i0 = q_begin + j * TC_QROWS;
    // Stage j & 1 has landed and the warpgroup is done with the other one.
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      load_stage((j + 1) & 1, i0 + TC_QROWS);
      cp_async_commit();
    }
    const uint32_t sQ = sK + (2 + 2 * (j & 1)) * S::TILE, sdO = sQ + S::TILE;
    const float* lse_s = reinterpret_cast<const float*>(rows_base + (j & 1) * S::ROWS);
    const float* delta_s = lse_s + TC_QROWS;

    // S^T = K Q^T and dP^T = V dO^T: keys key0 / key0 + 8, queries
    // i0 + 8 (i / 4) + 2 t + i % 2.
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_k<TC_KEYS>(sK, kk), desc_k<TC_QROWS>(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_k<TC_KEYS>(sV, kk), desc_k<TC_QROWS>(sdO, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const bool masked_tile =
        i0 + TC_QROWS > Tq || k0 + TC_KEYS > Tk || (CAUSAL && i0 < k0 + TC_KEYS - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);
      float p = exp2f(fmaf(st[i], scale_log2, -lse_s[c] * LOG2E));
      if (masked_tile) {
        // Masked pairs get weight exactly 0.
        const int qp = i0 + c, kp = key0 + 8 * ((i / 2) & 1);
        if (qp >= Tq || kp >= Tk || (CAUSAL && qp < kp)) p = 0.f;
      }
      dpt[i] = p * (dpt[i] - delta_s[c]) * scale;
      st[i] = p;
    }
    uint32_t pa[TC_QROWS / 16][4], dsa[TC_QROWS / 16][4];  // P^T, dS^T in bf16
    to_a_operand(st, pa);
    to_a_operand(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      fence_regs(dv_acc[p]);
      fence_regs(dk_acc[p]);
    }
#pragma unroll
    for (int kk = 0; kk < TC_QROWS / 16; ++kk)
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        wgmma_rs_n64_mn(dv_acc[p], pa[kk], desc_mn<TC_QROWS>(sdO, p, kk));
        wgmma_rs_n64_mn(dk_acc[p], dsa[kk], desc_mn<TC_QROWS>(sQ, p, kk));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      fence_regs(dv_acc[p]);
      fence_regs(dk_acc[p]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Tk) continue;
    const int64_t base = ((b * Tk + key) * H + h) * D + 2 * t;
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int e = 4 * jj + 2 * r;
        *reinterpret_cast<uint32_t*>(dk + base + 64 * p + 8 * jj) =
            pack_bf16(dk_acc[p][e], dk_acc[p][e + 1]);
        *reinterpret_cast<uint32_t*>(dv + base + 64 * p + 8 * jj) =
            pack_bf16(dv_acc[p][e], dv_acc[p][e + 1]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *g0, *g1;  // dq (dq pass); dk, dv (dk/dv pass)
  int B, Tq, Tk, H;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, D, CAUSAL>;
  const int smem = DqSmem<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Tq + DQ_BQ - 1) / DQ_BQ);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.g0), a.Tq, a.Tk,
      a.H, a.scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv_f32(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<float, D, CAUSAL>;
  const int smem = DkvSmem<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Tk + DKV_BK - 1) / DKV_BK);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.Tq, a.Tk, a.H, a.scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv_wgmma(const Args& a) {
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, CAUSAL>;
  const int smem = DkvTcSmem<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  dim3 grid(a.B * a.H, (a.Tk + TC_KEYS - 1) / TC_KEYS);
  kernel<<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.g0), static_cast<bf16*>(a.g1), a.Tq, a.Tk, a.H, a.scale);
  return cudaGetLastError();
}

// Pass 0 = dq, 1 = dk/dv; dtype 0 = float32, 1 = bfloat16.  The dk/dv pass
// in bfloat16 is the tensor-core kernel, every other pair a CUDA-core one.
template <int D, bool CAUSAL>
cudaError_t launch_pass(int pass, int dtype, const Args& a) {
  if (dtype == 0)
    return pass == 0 ? launch_dq<float, D, CAUSAL>(a) : launch_dkv_f32<D, CAUSAL>(a);
  if (dtype == 1)
    return pass == 0 ? launch_dq<__nv_bfloat16, D, CAUSAL>(a) : launch_dkv_wgmma<D, CAUSAL>(a);
  return cudaErrorInvalidValue;
}

int run(int pass, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* g0, void* g1, int B, int Tq, int Tk,
        int H, int D, int causal, int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), g0, g1, B, Tq, Tk, H, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64:
      return causal ? launch_pass<64, true>(pass, dtype, a) : launch_pass<64, false>(pass, dtype, a);
    case 128:
      return causal ? launch_pass<128, true>(pass, dtype, a)
                    : launch_pass<128, false>(pass, dtype, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
extern "C" int moolib_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int B, int Tq, int Tk, int H, int D, int causal,
                                   int dtype, float scale, void* stream) {
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, B, Tq, Tk, H, D, causal, dtype,
             scale, stream);
}

extern "C" int moolib_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int Tq, int Tk, int H, int D,
                                    int causal, int dtype, float scale, void* stream) {
  return run(1, q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H, D, causal, dtype, scale,
             stream);
}

extern "C" const char* moolib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
