// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a), plain
// C interface: the Mamba-2 mixer's prefill path, from a zero state.
//
// For each (b, h), with B and C shared across heads, chunk by chunk:
//
//     cum_t   = sum_{u <= t} a_h dt_u                       (within the chunk)
//     y_t     = exp(cum_t) C_t S
//             + sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u
//     S      <- exp(cum_last) S + sum_u dt_u exp(cum_last - cum_u) B_u x_u^T
//
// with S the (N, P) float32 state, x [B, L, H, P], dt [B, L, H], a [H],
// B / C [B, L, N]; y [B, L, H, P] in x's type and the final state
// [B, H, N, P] float32. Positions at or past L read dt = 0 and x = B = C = 0,
// so they leave the state as it is (the reference pads with zeros).
//
// Design: one block of 256 threads per (b, h, 64-column tile of P). The
// block walks the chunks of kChunk = 64 positions in a loop and keeps the
// state in shared memory for the whole sequence, so x, dt, B and C are read
// from device memory once per block and y and the state written once. Per
// chunk: the x tile and dt are staged; two warps scan a dt into cum; then
// for each 32-wide slice of the state rows, B and C's slices are staged and
// the threads, as a 16 x 16 grid each owning a 4 x 4 register tile, add the
// slice's share of C B^T (64 x 64) and of C S (the inter term, from the old
// state), after which the slice's state rows are updated in place. C B^T is
// then masked to u <= t, weighted by exp(cum_t - cum_u) dt_u (the exp is
// computed only below the diagonal: above it, it overflows) and staged, and
// its product with the x tile is added to y. The products are float32 FMAs
// from shared memory, not tensor-core instructions: what bounds the
// function is operations, and this first version runs at the FMA units'
// rate. A chunk of 64 (the TPU kernel's is 128) keeps the block at about
// 84 KB of shared memory at N = 128, so two blocks fit into an SM. C B^T
// does not depend on h, but each block recomputes it: sharing it is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // positions per chunk
constexpr int kPT = 64;        // columns of P per block
constexpr int kNT = 32;        // state rows per staged slice of B and C
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kMaxState = 256;
constexpr int kBP = kNT + 1;   // row pitch of the B and C slices
constexpr int kGP = kChunk + 1;  // row pitch of C B^T

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {  // in elements; the last dimension of each is contiguous
  long long x_b, x_l, x_h;
  long long dt_b, dt_l, dt_h;
  long long b_b, b_l;
  long long c_b, c_l;
};

size_t smem_floats(int n_pad) {
  return static_cast<size_t>(kChunk) * kPT      // x tile
         + static_cast<size_t>(n_pad) * kPT     // state
         + 2 * static_cast<size_t>(kChunk) * kBP  // B and C slices
         + static_cast<size_t>(kChunk) * kGP    // C B^T
         + 4 * static_cast<size_t>(kChunk);     // dt, cum, exp(cum), w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ state_out, int len, int nh, int np,
                int ns, int n_pad, Strides st) {
  extern __shared__ float smem[];
  float* xs = smem;                   // [kChunk][kPT]
  float* ss = xs + kChunk * kPT;      // [n_pad][kPT]
  float* bs = ss + n_pad * kPT;       // [kChunk][kBP]
  float* cs = bs + kChunk * kBP;      // [kChunk][kBP]
  float* gs = cs + kChunk * kBP;      // [kChunk][kGP]
  float* dts = gs + kChunk * kGP;     // [kChunk]
  float* cum = dts + kChunk;
  float* ecum = cum + kChunk;
  float* wts = ecum + kChunk;

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float ah = a[h];

  const T* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* bb = bm + b * st.b_b;
  const T* cb = cm + b * st.c_b;

  for (int i = tid; i < n_pad * kPT; i += kThreads) ss[i] = 0.0f;

  const int n_chunks = (len + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    __syncthreads();  // the previous chunk is consumed (the state is zeroed)
    for (int i = tid; i < kChunk * kPT; i += kThreads) {
      const int u = i / kPT;
      const int pp = i - u * kPT;
      xs[i] = (t0 + u < len && p0 + pp < np)
                  ? to_float(xb[(t0 + u) * st.x_l + pp])
                  : 0.0f;
    }
    if (tid < kChunk) {
      const float d = (t0 + tid < len) ? dtb[(t0 + tid) * st.dt_l] : 0.0f;
      dts[tid] = d;
      // inclusive scan of a * dt within each of the two warps
      float v = ah * d;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, o);
        if ((tid & 31) >= o) v += up;
      }
      cum[tid] = v;
    }
    __syncthreads();
    if (tid >= 32 && tid < kChunk) cum[tid] += cum[31];
    __syncthreads();
    if (tid < kChunk) {
      ecum[tid] = expf(cum[tid]);
      wts[tid] = dts[tid] * expf(cum[kChunk - 1] - cum[tid]);
    }
    // (the loop below synchronises before anything reads ecum or wts)

    float yacc[4][4], gacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yacc[i][j] = 0.0f;
        gacc[i][j] = 0.0f;
      }

    for (int n0 = 0; n0 < n_pad; n0 += kNT) {
      for (int i = tid; i < kChunk * kNT; i += kThreads) {
        const int u = i / kNT;
        const int k = i - u * kNT;
        float bv = 0.0f, cv = 0.0f;
        if (t0 + u < len && n0 + k < ns) {
          bv = to_float(bb[(t0 + u) * st.b_l + n0 + k]);
          cv = to_float(cb[(t0 + u) * st.c_l + n0 + k]);
        }
        bs[u * kBP + k] = bv;
        cs[u * kBP + k] = cv;
      }
      __syncthreads();
      // C B^T (rows t = ty + 16 i, columns u = tx + 16 j) and C S_old
      // (rows t, columns p = tx + 16 j) over this slice's state rows
#pragma unroll 4
      for (int k = 0; k < kNT; ++k) {
        float cr[4], br[4], sr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cr[i] = cs[(ty + 16 * i) * kBP + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          br[j] = bs[(tx + 16 * j) * kBP + k];
          sr[j] = ss[(n0 + k) * kPT + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            gacc[i][j] += cr[i] * br[j];
            yacc[i][j] += cr[i] * sr[j];
          }
      }
      __syncthreads();  // every read of the slice's old state rows is done
      // the slice's state rows n0 + ty + 16 r (r < 2), columns tx + 16 j
      const float d_last = expf(cum[kChunk - 1]);
      float su[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) su[r][j] = 0.0f;
#pragma unroll 4
      for (int u = 0; u < kChunk; ++u) {
        const float wu = wts[u];
        float bw[2], xr[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) bw[r] = bs[u * kBP + ty + 16 * r] * wu;
#pragma unroll
        for (int j = 0; j < 4; ++j) xr[j] = xs[u * kPT + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) su[r][j] += bw[r] * xr[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* s = ss + (n0 + ty + 16 * r) * kPT + tx + 16 * j;
          *s = d_last * *s + su[r][j];
        }
      __syncthreads();  // the slices of B and C are consumed
    }

    // the inter term's decay, and C B^T masked and weighted into shared
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      const float ct = cum[t];
      const float et = ecum[t];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = tx + 16 * j;
        yacc[i][j] *= et;
        gs[t * kGP + u] =
            u <= t ? gacc[i][j] * expf(ct - cum[u]) * dts[u] : 0.0f;
      }
    }
    __syncthreads();
    // the intra term: (C B^T) x over u <= t (rows past ty + 48 are 0)
    const int u_end = min(kChunk, ty + 49);
#pragma unroll 4
    for (int u = 0; u < u_end; ++u) {
      float gr[4], xr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gr[i] = gs[(ty + 16 * i) * kGP + u];
#pragma unroll
      for (int j = 0; j < 4; ++j) xr[j] = xs[u * kPT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] += gr[i] * xr[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= len) continue;
      T* yrow = y + ((static_cast<long long>(b) * len + t) * nh + h) * np;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx + 16 * j;
        if (p < np) store(yrow + p, yacc[i][j]);
      }
    }
  }
  __syncthreads();
  float* so = state_out + (static_cast<long long>(b) * nh + h) * ns * np;
  for (int i = tid; i < ns * kPT; i += kThreads) {
    const int n = i / kPT;
    const int pp = i - n * kPT;
    if (p0 + pp < np) so[static_cast<long long>(n) * np + p0 + pp] =
        ss[n * kPT + pp];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, void* y, float* state, int n_batch, int len,
           int nh, int np, int ns, const Strides& st, cudaStream_t stream) {
  const int n_pad = (ns + kNT - 1) / kNT * kNT;
  const size_t bytes = smem_floats(n_pad) * sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((np + kPT - 1) / kPT, nh, n_batch);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), state, len, nh, np, ns,
      n_pad, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of x, B, C and y); dt and a are float32.
// x is [B, L, H, P] given by its (b, l, h) strides, dt [B, L, H] by its
// (b, l, h) strides, B and C [B, L, N] by their (b, l) strides, each in
// elements with the last dimension contiguous; y is contiguous
// [B, L, H, P] and the state contiguous [B, H, N, P]. 1 <= N <= 256.
// Returns a cudaError_t code (0 on success).
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, void* y, void* state, int n_batch, int len, int nh,
    int np, int ns, long long x_b, long long x_l, long long x_h,
    long long dt_b, long long dt_l, long long dt_h, long long b_b,
    long long b_l, long long c_b, long long c_l, void* stream) {
  if (ns < 1 || ns > kMaxState) return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch <= 0 || nh <= 0 || np <= 0) return 0;
  const Strides st{x_b, x_l, x_h, dt_b, dt_l, dt_h, b_b, b_l, c_b, c_l};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, dtf, af, bm, cm, y, sf, n_batch, len, nh, np, ns,
                         st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, bm, cm, y, sf, n_batch, len, nh,
                                 np, ns, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
