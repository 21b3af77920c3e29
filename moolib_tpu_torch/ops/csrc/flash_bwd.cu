// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of moolib_tpu/ops/flash_attention.py
// launched by `_flash_backward`:
//   - `_flash_bwd_dq_kernel`  -> flash_bwd_dq_kernel below (the dq pass);
//   - `_flash_bwd_dkv_kernel` -> flash_bwd_dkv_kernel below (the dk/dv pass).
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
// Design.  Two passes and no atomics, as on the TPU: the dq pass runs one
// CTA per (batch*head, 64-row query tile) sweeping 32-key K/V tiles; the
// dk/dv pass runs one CTA per (batch*head, 32-row key tile) sweeping 32-row
// Q/dO tiles.  Every gradient element then has exactly one writer and a
// fixed summation order, so results are bitwise reproducible run to run.
// Tiles are staged through shared memory as f32 (bf16 widened on load, as
// in flash_fwd.cu), 128 threads per CTA: thread (ty, tx) = (tid / 8, tid % 8)
// owns R consecutive tile rows (R = 4 in the dq pass, 2 in the dk/dv pass)
// and the 4 score columns tx + 8*j; its accumulators are the dims
// 4*tx + 32*c .. +3 of its rows.  The dk/dv pass keeps two f32 accumulators
// per row, so it takes half the rows per thread to stay near the forward's
// register count.  Score tiles go to shared memory and are read back only
// by the warp that wrote them, so a warp barrier orders the two products.
//
// What bounds it on the card.  At the training shape (16, 1024, 8, 128) bf16
// causal the dq pass does 6*D and the dk/dv pass 8*D operations per attended
// pair against ~5 and ~6 [B, T, H, D] tensors of traffic: both are bound by
// arithmetic.  These first kernels run their products on the f32 CUDA cores
// (FMA), not the tensor cores; mma/wgmma, TMA and warp specialisation are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int D, bool CAUSAL>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, D, CAUSAL>;
  const int smem = DkvSmem<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Tk + DKV_BK - 1) / DKV_BK);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.g0),
      static_cast<T*>(a.g1), a.Tq, a.Tk, a.H, a.scale);
  return cudaGetLastError();
}

// Pass: 0 = dq, 1 = dk/dv.
template <typename T, int D, bool CAUSAL>
cudaError_t launch_pass(int pass, const Args& a) {
  return pass == 0 ? launch_dq<T, D, CAUSAL>(a) : launch_dkv<T, D, CAUSAL>(a);
}

template <typename T>
cudaError_t dispatch(int pass, int D, int causal, const Args& a) {
  switch (D) {
    case 64:
      return causal ? launch_pass<T, 64, true>(pass, a) : launch_pass<T, 64, false>(pass, a);
    case 128:
      return causal ? launch_pass<T, 128, true>(pass, a) : launch_pass<T, 128, false>(pass, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int pass, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* g0, void* g1, int B, int Tq, int Tk,
        int H, int D, int causal, int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), g0, g1, B, Tq, Tk, H, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(pass, D, causal, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(pass, D, causal, a);
  return cudaErrorInvalidValue;
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
