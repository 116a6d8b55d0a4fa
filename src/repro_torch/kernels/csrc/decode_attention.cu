// GQA KV-cache decode attention for Hopper (sm_90a), plain C interface.
//
// One new query token per sequence attends over its cache:
//
//     o[b, h] = softmax_t(q[b, h] . k[b, t, g] * scale) @ v[b, t, g]
//
// for t < lengths[b] (clamped to S), g = h / rep, rep = Hq / Hkv. The
// running max, sum and accumulator are float32 whatever the storage types,
// with the reference's masking: a masked score is -1e30, its weight is
// zeroed AFTER the exp, and the output divides by the sum where it is not
// 0, else by 1. q and the cache are each float32 or bfloat16, of one type
// or not (say float32 activations over a bfloat16 cache): as in the TPU
// kernel each operand is upcast on its own, and q is never rounded to the
// cache's type. The output is in q's type.
//
// Design: one block per (sequence b, kv head g) serves the rep query heads
// of that group, so each K/V row of the cache is read from device memory
// once per sequence (the property the TPU kernel was built around). The
// block walks the live prefix of the cache in tiles of kTile positions;
// each tile's K and V rows are staged in shared memory as float32 (K rows
// padded by one float so lanes reading different rows hit different banks)
// and every warp then serves one query head at a time: lane t scores cache
// position t of the tile, the warp reduces max and sum with shuffles, and
// the lanes split the head dimension to fold p @ V into the head's
// accumulator, which lives in shared memory. Tiles at or past the
// sequence's length are never loaded, so stale rows beyond it are never
// read. What bounds it on an H100 is bytes (the live K/V rows); this first
// version loads a tile, then computes on it, with no overlap and no split
// over S, so it is far from that bound at small batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // cache positions per tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long q_b, q_h;        // q [B, Hq, D]
  long long k_b, k_s, k_h;   // k cache [B, S, Hkv, D]
  long long v_b, v_s, v_h;   // v cache [B, S, Hkv, D]
};

inline size_t smem_floats(int rep, int d) {
  return static_cast<size_t>(kTile) * (d + 1)   // K tile, padded rows
         + static_cast<size_t>(kTile) * d       // V tile
         + 2 * static_cast<size_t>(rep) * d     // q rows, accumulators
         + 2 * static_cast<size_t>(rep)         // running max and sum
         + kWarps * 32;                         // one tile of weights a warp
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        int s_len, int hq, int hkv, int d, float scale,
                        Strides st) {
  extern __shared__ float smem[];
  const int rep = hq / hkv;
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = d + 1;
  const int nv = d / 8;  // 8-element chunks per row
  float* ks = smem;                    // [kTile][d + 1]
  float* vs = ks + kTile * dp;         // [kTile][d]
  float* qs = vs + kTile * d;          // [rep][d]
  float* acc = qs + rep * d;           // [rep][d]
  float* run_m = acc + rep * d;        // [rep]
  float* run_l = run_m + rep;          // [rep]
  float* ps = run_l + rep;             // [kWarps][32]

  const int len = max(0, min(lengths[b], s_len));
  const T* kb = k + b * st.k_b + g * st.k_h;
  const T* vb = v + b * st.v_b + g * st.v_h;

  for (int i = tid; i < rep * nv; i += kThreads) {
    const int r = i / nv;
    const int c = (i - r * nv) * 8;
    float f[8];
    load8(q + b * st.q_b + static_cast<long long>(g * rep + r) * st.q_h + c,
          f);
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[r * d + c + j] = f[j];
  }
  for (int i = tid; i < rep * d; i += kThreads) acc[i] = 0.0f;
  for (int r = tid; r < rep; r += kThreads) {
    run_m[r] = kNegInf;
    run_l[r] = 0.0f;
  }

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int nt = min(kTile, len - t0);
    __syncthreads();  // the previous tile is consumed; q/acc are written
    for (int i = tid; i < nt * nv; i += kThreads) {
      const int t = i / nv;
      const int c = (i - t * nv) * 8;
      const long long pos = t0 + t;
      float fk[8], fv[8];
      load8(kb + pos * st.k_s + c, fk);
      load8(vb + pos * st.v_s + c, fv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[t * dp + c + j] = fk[j];
        vs[t * d + c + j] = fv[j];
      }
    }
    __syncthreads();
    for (int r = warp; r < rep; r += kWarps) {
      const float m_prev = run_m[r];
      const float l_prev = run_l[r];
      const bool live = lane < nt;
      float s = kNegInf;
      if (live) {
        const float* qr = qs + r * d;
        const float* kr = ks + lane * dp;
        float dot = 0.0f;
        for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
        s = dot * scale;
      }
      const float m_cur = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_cur);
      const float p = live ? expf(s - m_cur) : 0.0f;
      const float p_sum = warp_sum(p);
      ps[warp * 32 + lane] = p;
      __syncwarp();
      float* ar = acc + r * d;
      for (int c = lane; c < d; c += 32) {
        float a = ar[c] * alpha;
        for (int t = 0; t < nt; ++t) a += ps[warp * 32 + t] * vs[t * d + c];
        ar[c] = a;
      }
      if (lane == 0) {
        run_m[r] = m_cur;
        run_l[r] = l_prev * alpha + p_sum;
      }
      __syncwarp();  // ps is rewritten by this warp's next head
    }
  }
  __syncthreads();
  TQ* ob = out + static_cast<long long>(b) * hq * d +
          static_cast<long long>(g) * rep * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    const float l = run_l[i / d];
    store(ob + i, acc[i] / (l == 0.0f ? 1.0f : l));
  }
}

template <typename TQ, typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int n_batch, int s_len, int hq, int hkv, int d,
           float scale, const Strides& st, cudaStream_t stream) {
  const size_t bytes = smem_floats(hq / hkv, d) * sizeof(float);
  if (bytes > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t set = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(n_batch, hkv);
  decode_attention_kernel<TQ, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), s_len, hq, hkv, d, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (the caches') and q_dtype: 0 float32, 1 bfloat16. Strides are in
// elements; the head dimension is contiguous. Returns a cudaError_t code
// (0 on success).
extern "C" int decode_attention_launch(
    int dtype, int q_dtype, const void* q, const void* k, const void* v,
    const void* lengths, void* out, int n_batch, int s_len, int hq, int hkv,
    int d, float scale, long long q_b, long long q_h, long long k_b,
    long long k_s, long long k_h, long long v_b, long long v_s, long long v_h,
    void* stream) {
  if (n_batch <= 0 || hkv <= 0) return 0;
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && q_dtype == 0)
    return launch<float, float>(q, k, v, lengths, out, n_batch, s_len, hq,
                                hkv, d, scale, st, s);
  if (dtype == 1 && q_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, out, n_batch, s_len, hq, hkv, d, scale, st, s);
  if (dtype == 1 && q_dtype == 0)
    return launch<float, __nv_bfloat16>(q, k, v, lengths, out, n_batch,
                                        s_len, hq, hkv, d, scale, st, s);
  if (dtype == 0 && q_dtype == 1)
    return launch<__nv_bfloat16, float>(q, k, v, lengths, out, n_batch,
                                        s_len, hq, hkv, d, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
