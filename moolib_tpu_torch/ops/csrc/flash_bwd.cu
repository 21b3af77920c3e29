// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of moolib_tpu/ops/flash_attention.py
// launched by `_flash_backward`:
//   - `_flash_bwd_dq_kernel` (:249, launched at :399) -> the dq pass,
//     flash_bwd_dq_wgmma_kernel in bfloat16, flash_bwd_dq_kernel in float32;
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
// [B, Tq, H] f32; dq in q's dtype, dk/dv in k's.  Any T >= 1: rows at or
// past T load as zeros and tail tiles are masked.  Causal alignment is at
// position 0 (q_pos >= k_pos); tiles wholly above the diagonal are skipped.
//
// Two passes and no atomics, as on the TPU: the dq pass owns a query tile
// and sweeps K/V, the dk/dv pass owns a K/V tile and sweeps Q/dO.  Every
// gradient element has one writer and a fixed summation order, so results
// are bitwise reproducible run to run.
//
// What bounds it on the card.  Per attended pair the dq pass does 6 D
// operations (s, dp, dq) and the dk/dv pass 8 D (s, dp, dv, dk), against ~5
// and ~6 [B, T, H, D] tensors of traffic.  At the training shape
// (16, 1024, 8, 128) bf16 causal that is 51.6 and 68.8 GFLOP against 169
// and 202 MB: both passes are bound by the tensor cores' arithmetic
// (989 TFLOP/s bf16 dense), so all their products run on wgmma.
//
// bfloat16: one CTA of one warpgroup (128 threads) per (batch * head,
// 64-row tile), two CTAs an SM (six [64, D] bf16 tiles, 97 KB at D = 128).
// The CTA's own tile and its partner stay in shared memory; 64-row tiles of
// the other side stream through a ring of two stages, filled by cp.async
// while the warpgroup computes on the other stage.  Tiles stay bf16 in the
// 128-byte swizzled layout of hopper.cuh.  Both score products are wgmma
// m64n64k16 chains with every operand K-major from shared memory, into f32
// registers; p and ds are formed in f32 on that accumulator fragment, and
// rounded to bf16 they are the register A operands of the gradient
// products, whose B operand is read MN-major through the descriptor's
// transpose bit, one m64n64k16 per 64-column panel of D.  Only tiles that
// cross the diagonal or a ragged end pay for the per-pair mask.
//   - dq pass, flash_bwd_dq_wgmma_kernel: the CTA owns 64 query rows (Q and
//     dO stay), K and V stream.  Scores in the natural layout, S = Q K^T
//     and dP = dO V^T, [queries x keys]: each thread holds two query rows,
//     so their lse and delta sit in registers for the whole sweep.  dS,
//     rounded to bf16 where the TPU kernel casts it (:282), is already the
//     A operand of dq += dS K.  The [64, D] f32 dq accumulator stays in
//     registers.  Under causal the last query tiles, which see the most
//     keys, launch first, and the sweep stops at the first key tile wholly
//     above the tile's diagonal.
//   - dk/dv pass, flash_bwd_dkv_wgmma_kernel: the CTA owns 64 keys (K and V
//     stay), Q and dO stream with their rows of lse and delta.  The TPU
//     kernel's transposed scores, S^T = K Q^T and dP^T = V dO^T, so that
//     P^T and dS^T (rounded as at :323-335) are the A operands of
//     dV += P^T dO and dK += dS^T Q; both [64, D] accumulators stay in
//     registers.  Under causal the first key tiles launch first.
//
// float32: flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the CUDA-core
// design of the first port, the only products still off the tensor cores.
// A float32 product on the tensor cores would be TF32, too coarse for the
// float32 tolerances (1e-4).  The dq pass runs one CTA per (batch * head,
// 64-row query tile) sweeping 32-key K/V tiles; the dk/dv pass one CTA per
// (batch * head, 32-row key tile) sweeping 32-row Q/dO tiles.  Tiles are
// staged through shared memory as f32, 128 threads a CTA: thread (ty, tx) =
// (tid / 8, tid % 8) owns R consecutive tile rows (4 in the dq pass, 2 in
// the dk/dv pass) and the 4 score columns tx + 8 j; its accumulators are
// the dims 4 tx + 32 c .. +3 of its rows, and score tiles go through shared
// memory, read back only by the warp that wrote them.
//
// The dtype dispatch is in launch_pass(): a bfloat16 call reaches only the
// tensor-core kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- float32: CUDA cores ------------------------------------------------

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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Stage rows [row0, row0 + ROWS) of one head into smem; rows at or past T
// are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t b, int h,
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

template <int D, int R>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[R][D / 32][4],
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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Tq, int Tk, int H, float scale) {
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

  load_tile<D, DQ_BQ>(Qs, q, b, h, q0, Tq, H);
  load_tile<D, DQ_BQ>(dOs, dout, b, h, q0, Tq, H);
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
    load_tile<D, NCOL>(Ks, k, b, h, k0, Tk, H);
    load_tile<D, NCOL>(Vs, v, b, h, k0, Tk, H);
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
  store_rows<D, R>(dq, acc, b, h, q0, Tq, H, ty, tx);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int H,
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

  load_tile<D, DKV_BK>(Ks, k, b, h, k0, Tk, H);
  load_tile<D, DKV_BK>(Vs, v, b, h, k0, Tk, H);
  float acc_dk[R][D / 32][4], acc_dv[R][D / 32][4];
  zero<D, R>(acc_dk);
  zero<D, R>(acc_dv);

  // Causal: queries before the tile's first key see none of its keys.
  const int q_begin = CAUSAL ? (k0 / NCOL) * NCOL : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += NCOL) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D, NCOL>(Qs, q, b, h, q0, Tq, H);
    load_tile<D, NCOL>(dOs, dout, b, h, q0, Tq, H);
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
  store_rows<D, R>(dk, acc_dk, b, h, k0, Tk, H, ty, tx);
  store_rows<D, R>(dv, acc_dv, b, h, k0, Tk, H, ty, tx);
}

// ---- bfloat16: tensor cores ---------------------------------------------

constexpr int TC_ROWS = 64;      // rows of every tile: a CTA's own, and each ring stage's
constexpr int TC_THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcSmem {  // the CTA's two tiles, then the two tiles of stages 0 and 1
  static constexpr int TILE = TC_ROWS * D * 2;  // one [64, D] bf16 tile
  static constexpr int ROWS = 2 * TC_ROWS * 4;  // lse and delta of one dk/dv stage
  static constexpr int DQ_BYTES = 6 * TILE + 1024;  // 1024 B to align
  static constexpr int DKV_BYTES = 6 * TILE + 2 * ROWS + 1024;
};

// Store a [64, D] f32 accumulator (PANELS of m64n64 fragments) as bf16
// rows row0 and row0 + 8 of head h of a [B, T, H, D] tensor, rows at or
// past T left out.
template <int PANELS>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[PANELS][32],
                                          int64_t b, int h, int row0, int T, int H, int t) {
  constexpr int D = 64 * PANELS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* dst = out + ((b * T + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int e = 4 * jj + 2 * r;
        *reinterpret_cast<uint32_t*>(dst + 64 * p + 8 * jj) =
            hopper::pack_bf16(acc[p][e], acc[p][e + 1]);
      }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H, float scale) {
  using namespace hopper;
  using S = TcSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u, sdO = sQ + S::TILE;

  const int64_t b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // Causal: the last query tiles, which see the most keys, launch first.
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TC_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int row0 = q0 + 16 * warp + g;  // this thread's queries: row0, row0 + 8
  const float scale_log2 = scale * LOG2E;

  // Causal: keys past the tile's last query row are masked for every row.
  const int kv_end = CAUSAL ? min(Tk, q0 + TC_ROWS) : Tk;
  const int n_tiles = (kv_end + TC_ROWS - 1) / TC_ROWS;

  // Stage `stage` of the ring: the K and V tiles from key k0.
  auto load_stage = [&](int stage, int k0) {
    const uint32_t sK = sQ + (2 + 2 * stage) * S::TILE;
    hopper::load_tile<TC_ROWS, D, TC_THREADS>(sK, k, b, h, k0, Tk, H);
    hopper::load_tile<TC_ROWS, D, TC_THREADS>(sK + S::TILE, v, b, h, k0, Tk, H);
  };
  hopper::load_tile<TC_ROWS, D, TC_THREADS>(sQ, q, b, h, q0, Tq, H);
  hopper::load_tile<TC_ROWS, D, TC_THREADS>(sdO, dout, b, h, q0, Tq, H);
  load_stage(0, 0);
  cp_async_commit();

  // lse (in log2 units) and delta of this thread's two rows, for the sweep.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = row0 + 8 * r < Tq;
    const int64_t row = (b * Tq + row0 + 8 * r) * H + h;
    lse2[r] = valid ? lse[row] * LOG2E : 0.f;
    dlt[r] = valid ? delta[row] : 0.f;
  }
  float dq_acc[PANELS][32];
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[p][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TC_ROWS;
    // Stage j & 1 has landed and the warpgroup is done with the other one.
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      load_stage((j + 1) & 1, k0 + TC_ROWS);
      cp_async_commit();
    }
    const uint32_t sK = sQ + (2 + 2 * (j & 1)) * S::TILE, sV = sK + S::TILE;

    // S = Q K^T and dP = dO V^T: queries row0 / row0 + 8, keys
    // k0 + 8 (i / 4) + 2 t + i % 2.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<TC_ROWS>(sQ, kk), desc_k<TC_ROWS>(sK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<TC_ROWS>(sdO, kk), desc_k<TC_ROWS>(sV, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool masked_tile =
        q0 + TC_ROWS > Tq || k0 + TC_ROWS > Tk || (CAUSAL && k0 + TC_ROWS - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) & 1;
      float p = exp2f(fmaf(s[i], scale_log2, -lse2[r]));
      if (masked_tile) {
        // Masked pairs get weight exactly 0.
        const int qp = row0 + 8 * r, kp = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (qp >= Tq || kp >= Tk || (CAUSAL && qp < kp)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dlt[r]) * scale;  // dS
    }
    uint32_t dsa[TC_ROWS / 16][4];  // dS in bf16, the A operand of dq += dS K
    to_a_operand(dp, dsa);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) fence_regs(dq_acc[p]);
#pragma unroll
    for (int kk = 0; kk < TC_ROWS / 16; ++kk)
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        wgmma_rs_n64_mn(dq_acc[p], dsa[kk], desc_mn<TC_ROWS>(sK, p, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) fence_regs(dq_acc[p]);
  }
  store_acc(dq, dq_acc, b, h, row0, Tq, H, t);
}

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
  using S = TcSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u, sV = sK + S::TILE;
  const uint8_t* rows_base = smem_raw + (sK - raw) + 6 * S::TILE;  // generic pointer

  const int64_t b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int k0 = blockIdx.y * TC_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = scale * LOG2E;

  // Causal: queries before the tile's first key see none of its keys.
  const int q_begin = CAUSAL ? k0 : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + TC_ROWS - 1) / TC_ROWS : 0;

  // Stage `stage` of the ring: Q, dO, and the tile's lse and delta rows.
  auto load_stage = [&](int stage, int i0) {
    const uint32_t sQ = sK + (2 + 2 * stage) * S::TILE;
    hopper::load_tile<TC_ROWS, D, TC_THREADS>(sQ, q, b, h, i0, Tq, H);
    hopper::load_tile<TC_ROWS, D, TC_THREADS>(sQ + S::TILE, dout, b, h, i0, Tq, H);
    const int r = tid % TC_ROWS;
    const bool valid = i0 + r < Tq;
    const int64_t row = (b * Tq + (valid ? i0 + r : 0)) * H + h;
    cp_async_4(sK + 6 * S::TILE + stage * S::ROWS + tid * 4, (tid < TC_ROWS ? lse : delta) + row,
               valid);
  };

  if (n_tiles > 0) {
    hopper::load_tile<TC_ROWS, D, TC_THREADS>(sK, k, b, h, k0, Tk, H);
    hopper::load_tile<TC_ROWS, D, TC_THREADS>(sV, v, b, h, k0, Tk, H);
    load_stage(0, q_begin);
    cp_async_commit();
  }

  float dk_acc[PANELS][32], dv_acc[PANELS][32];
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int i0 = q_begin + j * TC_ROWS;
    // Stage j & 1 has landed and the warpgroup is done with the other one.
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      load_stage((j + 1) & 1, i0 + TC_ROWS);
      cp_async_commit();
    }
    const uint32_t sQ = sK + (2 + 2 * (j & 1)) * S::TILE, sdO = sQ + S::TILE;
    const float* lse_s = reinterpret_cast<const float*>(rows_base + (j & 1) * S::ROWS);
    const float* delta_s = lse_s + TC_ROWS;

    // S^T = K Q^T and dP^T = V dO^T: keys key0 / key0 + 8, queries
    // i0 + 8 (i / 4) + 2 t + i % 2.
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_k<TC_ROWS>(sK, kk), desc_k<TC_ROWS>(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_k<TC_ROWS>(sV, kk), desc_k<TC_ROWS>(sdO, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const bool masked_tile =
        i0 + TC_ROWS > Tq || k0 + TC_ROWS > Tk || (CAUSAL && i0 < k0 + TC_ROWS - 1);
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
    uint32_t pa[TC_ROWS / 16][4], dsa[TC_ROWS / 16][4];  // P^T, dS^T in bf16
    to_a_operand(st, pa);
    to_a_operand(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      fence_regs(dv_acc[p]);
      fence_regs(dk_acc[p]);
    }
#pragma unroll
    for (int kk = 0; kk < TC_ROWS / 16; ++kk)
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        wgmma_rs_n64_mn(dv_acc[p], pa[kk], desc_mn<TC_ROWS>(sdO, p, kk));
        wgmma_rs_n64_mn(dk_acc[p], dsa[kk], desc_mn<TC_ROWS>(sQ, p, kk));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      fence_regs(dv_acc[p]);
      fence_regs(dk_acc[p]);
    }
  }
  store_acc(dk, dk_acc, b, h, key0, Tk, H, t);
  store_acc(dv, dv_acc, b, h, key0, Tk, H, t);
}

// ---- launch -------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *g0, *g1;  // dq (dq pass); dk, dv (dk/dv pass)
  int B, Tq, Tk, H;
  float scale;
  cudaStream_t stream;
};

// Launch `kernel` over (batch * head, tiles of `rows` along a length of
// `len`) with `smem` bytes of dynamic shared memory, on the caller's stream;
// `args` are cast to the kernel's parameter types.  Returns the launch's
// error.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), const Args& a, int len, int rows, int threads,
                   int smem, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (len + rows - 1) / rows);
  kernel<<<grid, threads, smem, a.stream>>>(static_cast<P>(args)...);
  return cudaGetLastError();
}

// Pass 0 = dq, 1 = dk/dv; dtype 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores).
template <int D, bool CAUSAL>
cudaError_t launch_pass(int pass, int dtype, const Args& a) {
  using S = TcSmem<D>;
  if (dtype == 0 && pass == 0)
    return launch(flash_bwd_dq_kernel<D, CAUSAL>, a, a.Tq, DQ_BQ, THREADS, DqSmem<D>::BYTES,
                  a.q, a.k, a.v, a.dout, a.lse, a.delta, a.g0, a.Tq, a.Tk, a.H, a.scale);
  if (dtype == 0 && pass == 1)
    return launch(flash_bwd_dkv_kernel<D, CAUSAL>, a, a.Tk, DKV_BK, THREADS, DkvSmem<D>::BYTES,
                  a.q, a.k, a.v, a.dout, a.lse, a.delta, a.g0, a.g1, a.Tq, a.Tk, a.H, a.scale);
  if (dtype == 1 && pass == 0)
    return launch(flash_bwd_dq_wgmma_kernel<D, CAUSAL>, a, a.Tq, TC_ROWS, TC_THREADS,
                  S::DQ_BYTES, a.q, a.k, a.v, a.dout, a.lse, a.delta, a.g0, a.Tq, a.Tk, a.H,
                  a.scale);
  if (dtype == 1 && pass == 1)
    return launch(flash_bwd_dkv_wgmma_kernel<D, CAUSAL>, a, a.Tk, TC_ROWS, TC_THREADS,
                  S::DKV_BYTES, a.q, a.k, a.v, a.dout, a.lse, a.delta, a.g0, a.g1, a.Tq, a.Tk,
                  a.H, a.scale);
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
