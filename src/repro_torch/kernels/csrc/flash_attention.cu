// Blocked online-softmax GQA attention for Hopper (sm_90a), plain C
// interface: the prefill path's causal (or bidirectional) attention.
//
//     o[b, h, i] = softmax_j(q[b, h, i] . k[b, g, j] * scale) @ v[b, g, j]
//
// with g = h / rep, over keys j < lk and, when causal, j <= i + (lk - lq):
// the queries sit at the end of the lk-long context. float32 running max,
// sum and accumulator whatever the storage type (float32 or bfloat16), with
// the reference's masking: a masked score is -1e30, its weight is zeroed
// AFTER the exp, and the output divides by the sum where it is not 0, else
// by 1 (a query row with no visible key gives 0).
//
// Design: one block of 128 threads per (b * Hq + h, tile of kBQ = 64
// queries). The query tile is staged in shared memory once; the block then
// walks the key/value tiles of kBK = 32 positions up to the causal
// frontier of its last query (tiles wholly past it are never loaded),
// staging each in shared memory as float32. The 128 threads form a 16 x 8
// grid: thread (ty, tx) scores query rows ty + 16 i (i < 4) against key
// columns tx + 8 j (j < 4), so the 8 threads of a row group are 8 lanes of
// one warp and reduce the row's max and sum with three shuffles; the same
// thread then accumulates p @ V for its 4 rows and the head-dimension
// columns tx + 8 jj (jj < D / 8), in registers. Rows of Q and K are padded
// by one float in shared memory so the lanes of a warp read distinct banks.
// The products are float32 FMAs, not tensor-core instructions: at the
// prefill shapes the kernel is bound by operations, and this first version
// runs at the FMA units' rate, far below the bf16 tensor-core bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 8;
constexpr float kNegInf = -1e30f;

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

struct Strides {  // in elements; [B, H, L, D] with D contiguous
  long long q_b, q_h, q_l;
  long long k_b, k_h, k_l;
  long long v_b, v_h, v_l;
};

// Copy rows [row0, row0 + n_rows) of one head into a float32 tile with
// row pitch `pitch`; rows at or past `limit` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      long long row_stride, int row0,
                                      int n_rows, int limit) {
  constexpr int nv = D / 8;
  for (int i = threadIdx.x; i < n_rows * nv; i += kThreads) {
    const int r = i / nv;
    const int c = (i - r * nv) * 8;
    float f[8];
    if (row0 + r < limit) {
      load8(src + (row0 + r) * row_stride + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * pitch + c + j] = f[j];
  }
}

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (D + 1)    // Q tile
         + static_cast<size_t>(kBK) * (D + 1)  // K tile
         + static_cast<size_t>(kBK) * D        // V tile
         + static_cast<size_t>(kBQ) * (kBK + 1);  // weights
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int lq, int lk, int causal, float scale,
                       Strides st) {
  constexpr int kDc = D / 8;  // accumulator columns a thread owns
  constexpr int qp = D + 1;
  constexpr int pp = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [kBQ][D + 1]
  float* ks = qs + kBQ * qp;      // [kBK][D + 1]
  float* vs = ks + kBK * qp;      // [kBK][D]
  float* ps = vs + kBK * D;       // [kBQ][kBK + 1]

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int g = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;
  const int offset = lk - lq;

  const T* qh = q + b * st.q_b + h * st.q_h;
  const T* kh = k + b * st.k_b + g * st.k_h;
  const T* vh = v + b * st.v_b + g * st.v_h;
  stage<T, D>(qs, qp, qh, st.q_l, q0, kBQ, lq);

  float m[kRows], l[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.0f;
  }

  int k_end = lk;
  if (causal) k_end = min(lk, min(q0 + kBQ, lq) + offset);  // last row + 1
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    stage<T, D>(ks, qp, kh, st.k_l, k0, kBK, lk);
    stage<T, D>(vs, D, vh, st.v_l, k0, kBK, lk);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * qp + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 8 * j) * qp + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row + offset;
      bool ok[kCols];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        ok[j] = kpos < lk && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_cur = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_cur);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_cur) : 0.0f;
        ps[row * pp + tx + 8 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's weights come from the 8 lanes of its group

#pragma unroll 2
    for (int t = 0; t < kBK; ++t) {
      float vv[kDc];
#pragma unroll
      for (int c = 0; c < kDc; ++c) vv[c] = vs[t * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(ty + 16 * i) * pp + t];
#pragma unroll
        for (int c = 0; c < kDc; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  T* oh = out + (static_cast<long long>(bh) * lq) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= lq) continue;
    const float div = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < kDc; ++c)
      store(oh + static_cast<long long>(row) * D + tx + 8 * c,
            acc[i][c] / div);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int n_batch, int hq, int hkv, int lq, int lk, int causal,
           float scale, const Strides& st, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((lq + kBQ - 1) / kBQ, n_batch * hq);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, lq, lk,
      causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out,
             int n_batch, int hq, int hkv, int lq, int lk, int causal,
             float scale, const Strides& st, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, n_batch, hq, hkv, lq, lk, causal,
                           scale, st, s);
    case 64:
      return launch<T, 64>(q, k, v, out, n_batch, hq, hkv, lq, lk, causal,
                           scale, st, s);
    case 96:
      return launch<T, 96>(q, k, v, out, n_batch, hq, hkv, lq, lk, causal,
                           scale, st, s);
    case 128:
      return launch<T, 128>(q, k, v, out, n_batch, hq, hkv, lq, lk, causal,
                            scale, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; d in {32, 64, 96, 128}. q is [B, Hq, Lq, D]
// and k, v are [B, Hkv, Lk, D], each given by its (b, h, l) strides in
// elements with D contiguous; out is contiguous [B, Hq, Lq, D]. Returns a
// cudaError_t code (0 on success).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int n_batch, int hq, int hkv, int lq, int lk, int d, int causal,
    float scale, long long q_b, long long q_h, long long q_l, long long k_b,
    long long k_h, long long k_l, long long v_b, long long v_h,
    long long v_l, void* stream) {
  if (n_batch <= 0 || hq <= 0 || lq <= 0) return 0;
  const Strides st{q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, out, n_batch, hq, hkv, lq, lk, causal,
                           scale, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, out, n_batch, hq, hkv, lq, lk,
                                   causal, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
