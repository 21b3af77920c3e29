// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// moolib_tpu/ops/flash_attention.py:54 (launched by `_flash_forward`,
// :523): blockwise causal or full attention with an online softmax (running
// max, running sum and an f32 output accumulator), scale D**-0.5, masked
// pairs at weight exactly 0, K/V tiles wholly above the diagonal skipped.
// It emits `out` in the input dtype and the row logsumexp in f32.
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, H, D], out [B, Tq, H, D] (contiguous),
// lse [B, Tq, H].  Any T >= 1: rows at or past T load as zeros and tail
// tiles are masked.  Causal alignment is at position 0 (q_pos >= k_pos).
//
// What bounds it on the card.  Per attended (query, key) pair the forward
// does 4 D operations (Q K^T and P V); the call moves q, k, v and out once.
// At the training shape (16, 1024, 8, 128) bf16 causal that is 34.4 GFLOP,
// 0.035 ms at the bf16 tensor cores' 989 TFLOP/s, against 135 MB, 0.040 ms
// at 3.35 TB/s: the two bounds nearly meet, so the products must run on
// the tensor cores and the loads must stream under them.
//
// bfloat16: flash_fwd_wgmma_kernel, on the tensor cores.
//   - One CTA of two warpgroups (256 threads) per (batch * head, 128-row
//     query tile); warpgroup w owns query rows [64 w, 64 w + 64).  Under
//     causal the last query tiles, which see the most keys, launch first.
//   - Q stays in shared memory for the whole sweep; 128-key K and V tiles
//     stream through a ring of two stages, filled by cp.async from all 256
//     threads while the warpgroups compute on the other stage.  Tiles stay
//     bf16 in the 128-byte swizzled layout of hopper.cuh (Q 32 KB, each K/V
//     stage 64 KB at D = 128).
//   - S = Q K^T is one wgmma m64n128k16 chain per warpgroup (both operands
//     K-major from shared memory), f32 in registers.  The online softmax
//     runs on that accumulator fragment: each thread holds 2 rows, and the
//     row max and sum reduce across the 4 lanes of a quad by shuffles.
//   - P is rounded to bf16 (the TPU kernel's `p.astype(v.dtype)`, :90-93)
//     and becomes the register A operand of O += P V with no trip through
//     shared memory; V is read MN-major through the descriptor's transpose
//     bit, one m64n64k16 per 64-column panel.  S, m, l, lse and O stay f32.
//
// float32: flash_fwd_kernel below, the CUDA-core kernel of the first port.
// A float32 product on the tensor cores would be TF32, too coarse for the
// float32 tolerances (1e-4) the model's flash-vs-dense checks rely on.  One
// CTA of 128 threads per (batch * head, 64-row query tile) sweeps 32-key f32
// K/V tiles in shared memory; thread (tid / 8, tid % 8) owns 4 rows and the
// keys tx + 8 j, with the products on the f32 FMA units.
//
// The dtype dispatch is in moolib_flash_fwd: a bfloat16 call reaches only
// the tensor-core kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- float32: CUDA cores ------------------------------------------------

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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Stage rows [row0, row0 + ROWS) of one head into smem; rows at or past T
// are zero-filled.
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


// ---- bfloat16: tensor cores --------------------------------------------

constexpr int TC_BQ = 128;        // query rows per CTA, 64 per warpgroup
constexpr int TC_BK = 128;        // keys per K/V tile
constexpr int TC_THREADS = 256;   // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcSmem {
  static constexpr int Q = TC_BQ * D * 2;
  static constexpr int KV = TC_BK * D * 2;  // one K or one V tile
  static constexpr int BYTES = Q + 2 * 2 * KV + 1024;  // two K/V stages, 1024 B to align
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Tq, int Tk, int H, float scale) {
  using namespace hopper;
  using S = TcSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + S::Q;  // stage s: K at sKV + 2 s KV, V right after

  const int64_t b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TC_BQ;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const float scale_log2 = scale * LOG2E;

  // Causal: keys past the tile's last query row are masked for every row.
  const int kv_end = CAUSAL ? min(Tk, q0 + TC_BQ) : Tk;
  const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;

  hopper::load_tile<TC_BQ, D, TC_THREADS>(sQ, q, b, h, q0, Tq, H);
  hopper::load_tile<TC_BK, D, TC_THREADS>(sKV, k, b, h, 0, Tk, H);
  hopper::load_tile<TC_BK, D, TC_THREADS>(sKV + S::KV, v, b, h, 0, Tk, H);
  cp_async_commit();

  float o[PANELS][32];
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this thread's share of the running sum
  const uint32_t sQw = sQ + wg * 64 * 128;

  for (int j = 0; j < n_tiles; ++j) {
    // Tile j has landed and every warpgroup is done with tile j - 1, whose
    // stage the next copy overwrites.
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const uint32_t next = sKV + ((j + 1) & 1) * 2 * S::KV;
      hopper::load_tile<TC_BK, D, TC_THREADS>(next, k, b, h, (j + 1) * TC_BK, Tk, H);
      hopper::load_tile<TC_BK, D, TC_THREADS>(next + S::KV, v, b, h, (j + 1) * TC_BK, Tk, H);
      cp_async_commit();
    }
    const uint32_t sK = sKV + (j & 1) * 2 * S::KV, sV = sK + S::KV;
    const int k0 = j * TC_BK;

    float s[64];  // S = Q K^T: rows row0 / row0 + 8, keys k0 + 8 (i / 4) + 2 t + i % 2
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, desc_k<TC_BQ>(sQw, kk), desc_k<TC_BK>(sK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Masked pairs: past Tk, or above the diagonal for this warpgroup's rows.
    const bool masked_tile =
        k0 + TC_BK > Tk || (CAUSAL && k0 + TC_BK - 1 > q0 + 64 * wg);
    if (masked_tile) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int row = row0 + 8 * ((i / 2) & 1);
        if (col >= Tk || (CAUSAL && col > row)) s[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    float base[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with no key yet keeps base 0, so exp2 sees no inf - inf.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
      corr[r] = exp2f(m[r] * scale_log2 - base[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i / 2) & 1;
      // Masked pairs get weight exactly 0.
      const float p = s[i] == -INFINITY ? 0.f : exp2f(fmaf(s[i], scale_log2, -base[r]));
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= corr[(i / 2) & 1];

    uint32_t pa[TC_BK / 16][4];  // P in bf16, the A operand of P V
    to_a_operand(s, pa);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) fence_regs(o[p]);
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < PANELS; ++p) wgmma_rs_n64_mn(o[p], pa[kk], desc_mn<TC_BK>(sV, p, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) fence_regs(o[p]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / denom;
    __nv_bfloat16* dst = out + ((b * Tq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint32_t val = pack_bf16(o[p][4 * jj + 2 * r] * inv, o[p][4 * jj + 2 * r + 1] * inv);
        *reinterpret_cast<uint32_t*>(dst + 64 * p + 8 * jj) = val;
      }
    if (t == 0)
      lse[(b * Tq + row) * H + h] =
          m[r] == -INFINITY ? -1e30f : m[r] * scale + logf(denom);
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                         int B, int Tq, int Tk, int H, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma_kernel<D, CAUSAL>;
  const int smem = TcSmem<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + TC_BQ - 1) / TC_BQ);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Tq, Tk, H, scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                       int B, int Tq, int Tk, int H, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<float, D, CAUSAL>;
  const int smem = Layout<D>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), Tq, Tk, H, scale);
  return cudaGetLastError();
}

// dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
template <int D, bool CAUSAL>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int Tq, int Tk, int H, float scale, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D, CAUSAL>(q, k, v, out, lse, B, Tq, Tk, H, scale, stream);
  if (dtype == 1) return launch_wgmma<D, CAUSAL>(q, k, v, out, lse, B, Tq, Tk, H, scale, stream);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t dispatch_causal(int dtype, const void* q, const void* k, const void* v, void* out,
                            void* lse, int B, int Tq, int Tk, int H, int causal, float scale,
                            cudaStream_t stream) {
  return causal ? launch<D, true>(dtype, q, k, v, out, lse, B, Tq, Tk, H, scale, stream)
                : launch<D, false>(dtype, q, k, v, out, lse, B, Tq, Tk, H, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); the caller raises on anything else.
extern "C" int moolib_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                void* lse, int B, int Tq, int Tk, int H, int D,
                                int causal, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_causal<64>(dtype, q, k, v, out, lse, B, Tq, Tk, H, causal, scale, s);
    case 128:
      return dispatch_causal<128>(dtype, q, k, v, out, lse, B, Tq, Tk, H, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* moolib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
