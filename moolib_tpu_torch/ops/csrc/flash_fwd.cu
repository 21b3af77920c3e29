// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// moolib_tpu/ops/flash_attention.py (launched by `_flash_forward`): blockwise
// causal or full attention with an online softmax (running max, running sum
// and an f32 output accumulator), scale D**-0.5, masked scores -1e30,
// fully-masked rows held at weight 0, KV tiles above the diagonal skipped.
// It emits `out` in the input dtype and the row logsumexp in f32.
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, H, D], out [B, Tq, H, D] (contiguous),
// lse [B, Tq, H].  Any T >= 1: the tail tiles are masked, not rerouted.
//
// Design.  One CTA of 128 threads per (batch*head, 64-row query tile).  The
// query tile stays in shared memory for the whole KV sweep; each 32-key K/V
// tile is staged through shared memory as f32 (bf16 inputs are widened on
// load, so both input types share one f32 datapath).  Thread (ty, tx) with
// ty = tid / 8 and tx = tid % 8 owns query rows 4*ty .. 4*ty+3: it computes
// the scores of those rows against keys tx + 8*j, reduces the row max and
// sum across the 8 lanes of its row group by warp shuffles, and accumulates
// output dims 4*tx + 32*c .. +3.  The probabilities of a row group are
// written to shared memory and read back only by the same warp, so a warp
// barrier suffices between the two products.  Shared-memory rows are padded
// by 4 floats so the 16-byte K and V reads of a quarter-warp hit distinct
// banks.
//
// What bounds it on the card.  At the serving prefill shape (T = 1024,
// D = 128, bf16) attention does ~2*2*T^2*D/2 operations per head against
// ~4*T*D*2 bytes, far above the H100's ops-per-byte ridge: the bound is
// arithmetic.  This first kernel runs its products on the f32 CUDA cores
// (FMA), not the tensor cores, so it sits well below the bf16 tensor-core
// bound; wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 32;        // keys per K/V tile
constexpr int THREADS = 128;  // 16 row groups x 8 lanes
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int ROW = D + 4;   // Q/K/V smem row stride (floats)
  static constexpr int PROW = BK + 4; // P smem row stride (floats)
  static constexpr int FLOATS = BQ * ROW + 2 * BK * ROW + BQ * PROW;
  static constexpr int BYTES = FLOATS * 4;
};

// Four consecutive elements of a row, widened to f32.
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
    store4(dst + r * Layout<D>::ROW + c, val);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int H, float scale) {
  using L = Layout<D>;
  constexpr int DC = D / 32;  // float4 output chunks per row per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * L::ROW;
  float* Vs = Ks + BK * L::ROW;
  float* Ps = Vs + BK * L::ROW;

  const int bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;

  load_tile<T, D, BQ>(Qs, q, b, h, q0, Tq, H);

  float o[4][DC][4];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }

  // Causal: keys past the tile's last query row are masked for every row,
  // so the sweep stops there (the Pallas kernel's skipped upper tiles).
  const int kv_end = CAUSAL ? min(Tk, q0 + BQ) : Tk;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, BK>(Ks, k, b, h, k0, Tk, H);
    load_tile<T, D, BK>(Vs, v, b, h, k0, Tk, H);
    __syncthreads();

    // S = Q K^T for rows 4*ty+i, keys tx+8*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(Qs + (ty * 4 + i) * L::ROW + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(Ks + (tx + 8 * j) * L::ROW + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = s[i][j];
          acc = fmaf(qv[i].x, kv[j].x, acc);
          acc = fmaf(qv[i].y, kv[j].y, acc);
          acc = fmaf(qv[i].z, kv[j].z, acc);
          acc = fmaf(qv[i].w, kv[j].w, acc);
          s[i][j] = acc;
        }
    }

    // Online softmax per row; the 8 lanes of a row group are consecutive.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool valid = kp < Tk && (!CAUSAL || qp >= kp);
        s[i][j] = valid ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Masked scores get weight exactly 0 (a fully-masked row stays 0).
        const float p = s[i][j] <= NEG_INF * 0.5f ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * L::PROW + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_i[i] = l_i[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= corr;
    }
    __syncwarp();  // P rows of a row group are read only by its own warp

    // O += P V over the tile's keys.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(Ps + (ty * 4 + i) * L::PROW + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float4 vv = load4(Vs + (kk + e) * L::ROW + tx * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
            o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
            o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
            o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
          }
        }
      }
    }
    __syncwarp();  // P reads done before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    const int64_t row = (b * Tq + qp) * H + h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      float4 val = make_float4(o[i][c][0] / denom, o[i][c][1] / denom,
                               o[i][c][2] / denom, o[i][c][3] / denom);
      store4(out + row * D + tx * 4 + 32 * c, val);
    }
    if (tx == 0) lse[row] = m_i[i] + logf(denom);
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int Tq, int Tk, int H, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, CAUSAL>;
  const int smem = Layout<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Tq, Tk, H, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_causal(const void* q, const void* k, const void* v, void* out,
                            void* lse, int B, int Tq, int Tk, int H, int causal,
                            float scale, cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, out, lse, B, Tq, Tk, H, scale, stream)
                : launch<T, D, false>(q, k, v, out, lse, B, Tq, Tk, H, scale, stream);
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* out, void* lse,
                         int B, int Tq, int Tk, int H, int D, int causal, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 64:
      return dispatch_causal<T, 64>(q, k, v, out, lse, B, Tq, Tk, H, causal, scale, stream);
    case 128:
      return dispatch_causal<T, 128>(q, k, v, out, lse, B, Tq, Tk, H, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); the caller raises on anything else.
extern "C" int moolib_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                void* lse, int B, int Tq, int Tk, int H, int D,
                                int causal, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, out, lse, B, Tq, Tk, H, D, causal, scale, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, out, lse, B, Tq, Tk, H, D, causal, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* moolib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
