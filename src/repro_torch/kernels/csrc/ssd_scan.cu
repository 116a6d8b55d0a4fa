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
// It replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel), whose grid walks the chunks of one (b, h) in order with the
// state in VMEM. What bounds it on an H100 is operations: per (b, h, chunk
// of Q = 64) 2 Q N P for the inter term, 2 Q N P for the state update and
// 2 Q^2 P for the intra term, about 80x more than its bytes at the float32
// FMA rate. There are no tensor-core instructions: TF32 would round the
// inputs to ~5e-4, above the 1e-4 tolerance, so both dtypes compute in
// float32 on the FMA units, bfloat16 inputs widened once in shared memory.
//
// Design: two launches on one stream.
//   1. ssd_state_kernel: one block of 128 threads per (b, h, 32 columns of
//      P, 64 state rows) carries that part of the state across the chunks
//      in order, in registers (4 x 4 a thread): before chunk c it writes
//      the state to a workspace (S_in[c]), then adds the chunk's
//      sum_u w_u B_u x_u^T as an outer-product loop, two 16-byte shared
//      loads per 16 FMAs. B L / 64 more blocks form C B^T once per
//      (b, chunk) for all heads (64 x 64 floats each, in the workspace).
//   2. ssd_y_kernel: one block of 256 threads per (b, chunk, h, 64 columns
//      of P) forms y from S_in[c] and C B^T, independent of the other
//      chunks: exp(cum_t) C S_in (K = N, none for the first chunk), then
//      the decay-masked C B^T times x (K = Q, the positions past a warp's
//      last row skipped), 4 x 4 a thread, 8 16-byte shared loads per 64
//      FMAs.
// At mamba2-2.7b's prefill (B 2, L 512, H 80, P 64, N 128) that is 16 + 640
// and 1,280 blocks where the first version ran 160 blocks that each walked
// all chunks in series. Each block stages its operands through a two-stage
// cp.async ring -- the state blocks half a chunk of B and x a stage, the
// next half (and the next chunk's dt) in flight while the current one is
// multiplied; the y blocks 32 state rows or positions a stage -- and
// widens (bfloat16) and scales them once they land: x by dt_u
// exp(cum_last - cum_u) (every warp scans the chunk's dt itself), C B^T by
// the decay exp(cum_t - cum_u) dt_u, computed only where u <= t: above the
// diagonal it overflows. Where x, B or C are not 16-byte aligned the same
// body loads them synchronously. The workspace holds B H (L / 64) N P
// float32 states (42 MB at the prefill shape, written once and read once)
// and the C B^T tiles. Both kernels move about 125 MB between L2 and
// shared memory at the prefill shape -- B re-read for every (head, P tile),
// C and C B^T for every head -- which a block count of 640 or more fixes,
// and they run at about a third of the FMA rate.
//
// The first version (ssd_serial_kernel) stays beside them as the partner
// that the card's smoke run times in turns with the new kernels; only a
// private launcher reaches it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChunk = 64;       // positions per chunk
constexpr int kMaxState = 256;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 128;   // state and C B^T blocks
constexpr int kYThreads = 256;  // y blocks
// state blocks: 64 state rows x 32 columns of P, half a chunk a ring stage
constexpr int kSN = 64, kSP = 32, kSK = 32;
// C B^T blocks: 64 x 64, 16 state rows a slice
constexpr int kGK = 16;
// y blocks: 64 positions x 64 columns of P, 32 state rows or positions a
// slice
constexpr int kYP = 64, kYK = 32;
constexpr int kHead = 3 * kChunk * 4;  // y blocks: dt, cum, exp(cum)
constexpr int kDtRing = 2 * kChunk * 4;  // two chunks' dt

struct Strides {  // in elements; the last dimension of each is contiguous
  long long x_b, x_l, x_h;
  long long dt_b, dt_l, dt_h;
  long long b_b, b_l;
  long long c_b, c_l;
};

struct Dims {
  int n_batch, len, nh, np, ns, chunks;
  int p_tiles;           // of kYP columns (y blocks)
  int s_tiles, n_tiles;  // of kSP columns and kSN state rows (state blocks)
  int p_pad;             // P rounded up to 4
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename E>
__device__ __forceinline__ E zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements of E per 16-byte chunk, and the shared row pitch of a tile of
// `cols` elements (one chunk of padding, so rows start on other banks)
template <typename E>
__host__ __device__ constexpr int vec_of() { return 16 / static_cast<int>(sizeof(E)); }
template <typename E>
__host__ __device__ constexpr int pitch_of(int cols) { return cols + vec_of<E>(); }

// A rows x cols tile of a row-major global matrix, of which the first
// vrows x vcols are read and the rest fill with zeros. cols is a multiple
// of the 16-byte chunk.
template <typename E>
struct Panel {
  const E* src;   // element (0, 0)
  long long ld;   // row stride, in elements
  int rows, cols, vrows, vcols;
};

// Copy a panel into shared memory (row pitch `pitch`), one 16-byte chunk a
// thread at a time: by cp.async (the caller commits and waits), or where
// the source is not 16-byte aligned by plain loads. A thread later widens
// exactly the chunks it copied (`widen`), so the two loops match.
template <bool kAsync, typename E>
__device__ __forceinline__ void load_panel(const Panel<E>& pn, E* dst,
                                           int pitch) {
  constexpr int kV = vec_of<E>();
  const int per_row = pn.cols / kV;
  for (int i = threadIdx.x; i < pn.rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kV;
    const int n = r < pn.vrows ? max(0, min(kV, pn.vcols - c)) : 0;
    E* d = dst + r * pitch + c;
    const E* s = pn.src + r * pn.ld + c;
    if constexpr (kAsync) {
      cp_async16(d, n > 0 ? s : pn.src, n * static_cast<int>(sizeof(E)));
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j) d[j] = j < n ? s[j] : zero_of<E>();
    }
  }
}

// Widen one 16-byte chunk of shared memory to float32, times `scale`
template <typename E>
__device__ __forceinline__ void widen_chunk(const E* raw, float* out,
                                            float scale) {
  constexpr int kV = vec_of<E>();
  const uint4 q = *reinterpret_cast<const uint4*>(raw);
  const E* v = reinterpret_cast<const E*>(&q);
#pragma unroll
  for (int j = 0; j < kV; j += 4)
    *reinterpret_cast<float4*>(out + j) =
        make_float4(to_float(v[j]) * scale, to_float(v[j + 1]) * scale,
                    to_float(v[j + 2]) * scale, to_float(v[j + 3]) * scale);
}

// Widen the chunks this thread copied from `raw` (pitch rp) into float32
// `out` (pitch op), times f(row, column); in place where E is float.
template <typename E, typename F>
__device__ __forceinline__ void widen(const Panel<E>& pn, const E* raw,
                                      int rp, float* out, int op, F f) {
  constexpr int kV = vec_of<E>();
  const int per_row = pn.cols / kV;
  for (int i = threadIdx.x; i < pn.rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kV;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + r * rp + c);
    const E* v = reinterpret_cast<const E*>(&q);
    float w[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) w[j] = to_float(v[j]) * f(r, c + j);
#pragma unroll
    for (int j = 0; j < kV; j += 4)
      *reinterpret_cast<float4*>(out + r * op + c + j) =
          make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]);
  }
}

struct One {
  __device__ float operator()(int, int) const { return 1.0f; }
};

// dt of the chunk's 64 positions into shared memory (0 past L)
template <bool kAsync>
__device__ __forceinline__ void load_dt(const float* dt, long long off,
                                         long long step, int live,
                                         float* dts) {
  const int u = threadIdx.x;
  if (u >= kChunk) return;
  const bool ok = u < live;
  if constexpr (kAsync) {
    cp_async4(dts + u, ok ? dt + off + u * step : dt, ok ? 4 : 0);
  } else {
    dts[u] = ok ? dt[off + u * step] : 0.0f;
  }
}

// cum[u] = sum_{v <= u} ah dt_v over the chunk's 64 positions, by the
// calling warp alone in registers: its lane l gets cum[2 l] and
// cum[2 l + 1]. Every block scans this way, so the state and y kernels
// agree bit for bit.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float ah,
                                             float& cum0, float& cum1) {
  const int l = threadIdx.x & 31;
  const float v0 = ah * dts[2 * l];
  const float v1 = v0 + ah * dts[2 * l + 1];
  float s = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, s, o);
    if (l >= o) s += up;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (l == 0) before = 0.0f;
  cum0 = before + v0;
  cum1 = before + v1;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------- register tiles

// acc (rows m0 .. m0 + 3, columns n0 .. n0 + 3) += A^T B over k < kn,
// with A [k][m] and B [k][n] in shared memory: two 16-byte loads a k
template <int kn>
__device__ __forceinline__ void mm_outer(float (&acc)[4][4], const float* a,
                                         int ap, const float* b, int bp,
                                         int m0, int n0) {
#pragma unroll
  for (int k = 0; k < kn; ++k) {
    const float4 av = ld4(a + k * ap + m0), bv = ld4(b + k * bp + n0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// acc (rows m0 .. m0 + kRows - 1, columns n0 .. n0 + 3) += A B over k < kn
// (a multiple of 4, at most kMax), with A [m][k] (pitch ap) and B [k][n]
// (pitch bp) in shared memory
template <int kRows, int kMax, int ap, int bp>
__device__ __forceinline__ void mm_rows(float (&acc)[kRows][4], const float* a,
                                        const float* b, int kn, int m0,
                                        int n0) {
  a += m0 * ap;
  b += n0;
#pragma unroll
  for (int k = 0; k < kMax; k += 4) {
    if (k >= kn) break;
    float4 bv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(b + (k + kk) * bp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 av = ld4(a + i * ap + k);
      acc[i][0] = fmaf(av.x, bv[0].x, acc[i][0]);
      acc[i][1] = fmaf(av.x, bv[0].y, acc[i][1]);
      acc[i][2] = fmaf(av.x, bv[0].z, acc[i][2]);
      acc[i][3] = fmaf(av.x, bv[0].w, acc[i][3]);
      acc[i][0] = fmaf(av.y, bv[1].x, acc[i][0]);
      acc[i][1] = fmaf(av.y, bv[1].y, acc[i][1]);
      acc[i][2] = fmaf(av.y, bv[1].z, acc[i][2]);
      acc[i][3] = fmaf(av.y, bv[1].w, acc[i][3]);
      acc[i][0] = fmaf(av.z, bv[2].x, acc[i][0]);
      acc[i][1] = fmaf(av.z, bv[2].y, acc[i][1]);
      acc[i][2] = fmaf(av.z, bv[2].z, acc[i][2]);
      acc[i][3] = fmaf(av.z, bv[2].w, acc[i][3]);
      acc[i][0] = fmaf(av.w, bv[3].x, acc[i][0]);
      acc[i][1] = fmaf(av.w, bv[3].y, acc[i][1]);
      acc[i][2] = fmaf(av.w, bv[3].z, acc[i][2]);
      acc[i][3] = fmaf(av.w, bv[3].w, acc[i][3]);
    }
  }
}

// acc (rows m0 .. m0 + 7, columns n0 + 16 j) += A B^T over k < kn, with
// A [m][k] and B [n][k] in shared memory (one pitch)
template <int kn>
__device__ __forceinline__ void mm_nt(float (&acc)[8][4], const float* a,
                                      const float* b, int pitch, int m0,
                                      int n0) {
#pragma unroll
  for (int k = 0; k < kn; k += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(b + (n0 + 16 * j) * pitch + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av = ld4(a + (m0 + i) * pitch + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------- shared memory layouts

template <typename T>
struct StateLayout {  // bytes of one ring stage, and of the float32 copy
  // half a chunk: B (32 positions x 64 state rows) and x (32 x 32)
  static constexpr int kB = kSK * pitch_of<T>(kSN) * sizeof(T);
  static constexpr int kX = kSK * pitch_of<T>(kSP) * sizeof(T);
  static constexpr int kStage = kB + kX;
  static constexpr int kWide =
      sizeof(T) == 4 ? 0 : kSK * (pitch_of<float>(kSN) + pitch_of<float>(kSP)) * 4;
  static constexpr int kBytes = kDtRing + 2 * kStage + kWide;
  // C B^T blocks: C and B, 64 positions x 16 state rows each
  static_assert(2 * kChunk * pitch_of<T>(kGK) * sizeof(T) <= kStage, "");
  static_assert(sizeof(T) == 4 || 2 * kChunk * pitch_of<float>(kGK) * 4 <= kWide, "");
};

template <typename T>
struct YLayout {
  static constexpr int kCA = kChunk * pitch_of<T>(kYK) * sizeof(T);    // C
  static constexpr int kGA = kChunk * pitch_of<float>(kYK) * 4;         // G
  static constexpr int kA = kCA > kGA ? kCA : kGA;
  static constexpr int kSB = kYK * pitch_of<float>(kYP) * 4;            // S
  static constexpr int kXB = kYK * pitch_of<T>(kYP) * sizeof(T);        // x
  static constexpr int kB = kSB > kXB ? kSB : kXB;
  static constexpr int kStage = kA + kB;
  static constexpr int kWide = sizeof(T) == 4 ? 0 : kGA + kSB;
  static constexpr int kBytes = kHead + 2 * kStage + kWide;
  static_assert(pitch_of<float>(kYK) == kYK + 4 && pitch_of<float>(kYP) == kYP + 4,
                "the products read float32 tiles at one pitch each");
};

// ---------------------------------------------------------------- kernels

// C B^T of one (b, chunk): G[t][u] = sum_n C_t,n B_u,n, 64 x 64 float32
template <typename T, bool kAsync>
__device__ __forceinline__ void cb_block(const T* __restrict__ bm,
                                         const T* __restrict__ cm,
                                         float* __restrict__ gmat, int b,
                                         int c, const Dims& d,
                                         const Strides& st,
                                         unsigned char* smem) {
  using L = StateLayout<T>;
  constexpr int kRP = pitch_of<T>(kGK), kWP = pitch_of<float>(kGK);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * kChunk;
  const int live = d.len - t0;
  unsigned char* ring = smem + kDtRing;
  float* wide = reinterpret_cast<float*>(ring + 2 * L::kStage);
  const T* cb = cm + b * st.c_b + t0 * st.c_l;
  const T* bb = bm + b * st.b_b + t0 * st.b_l;
  auto panel = [&](const T* src, long long ld, int s) {
    return Panel<T>{src + s * kGK, ld, kChunk, kGK, live, d.ns - s * kGK};
  };
  auto load_slice = [&](int s) {
    T* stage = reinterpret_cast<T*>(ring + (s & 1) * L::kStage);
    load_panel<kAsync>(panel(cb, st.c_l, s), stage, kRP);
    load_panel<kAsync>(panel(bb, st.b_l, s), stage + kChunk * kRP, kRP);
  };
  const int ug = lane & 15, tg = warp * 2 + (lane >> 4);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int slices = (d.ns + kGK - 1) / kGK;
  load_slice(0);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // slice s has landed; slice s - 1 is consumed
    if (s + 1 < slices) load_slice(s + 1);
    cp_async_commit();
    T* stage = reinterpret_cast<T*>(ring + (s & 1) * L::kStage);
    const float* ca = reinterpret_cast<const float*>(stage);
    const float* ba = ca + kChunk * kRP;
    if constexpr (sizeof(T) != 4) {
      widen(panel(cb, st.c_l, s), stage, kRP, wide, kWP, One{});
      widen(panel(bb, st.b_l, s), stage + kChunk * kRP, kRP,
            wide + kChunk * kWP, kWP, One{});
      ca = wide;
      ba = wide + kChunk * kWP;
      __syncthreads();
    }
    mm_nt<kGK>(acc, ca, ba, kWP, tg * 8, ug);
  }
  float* g = gmat + (static_cast<long long>(b) * d.chunks + c) * kChunk * kChunk;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      g[(tg * 8 + i) * kChunk + ug + 16 * j] = acc[i][j];
}

// The state of one (b, h) for 64 state rows and 32 columns of P, carried
// across the chunks in order in registers: before chunk c it is written
// to the workspace (S_in[c], rows of P rounded up to 4; chunk 0 starts
// from zero and is not written), then S <- exp(cum_last) S + sum_u dt_u
// exp(cum_last - cum_u) B_u x_u^T, half a chunk a ring stage, the next
// half (and the next chunk's dt) loading meanwhile; the final state goes
// to state_out. Every warp scans the chunk's dt itself. The first B L / 64
// blocks form C B^T instead.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, float* __restrict__ states,
                 float* __restrict__ gmat, float* __restrict__ state_out,
                 Dims d, Strides st) {
  using L = StateLayout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  int blk = blockIdx.x;
  if (blk < d.n_batch * d.chunks) {
    cb_block<T, kAsync>(bm, cm, gmat, blk / d.chunks, blk % d.chunks, d, st,
                        smem);
    return;
  }
  blk -= d.n_batch * d.chunks;
  const int nt = blk % d.n_tiles;
  blk /= d.n_tiles;
  const int pt = blk % d.s_tiles;
  blk /= d.s_tiles;
  const int h = blk % d.nh;
  const int b = blk / d.nh;

  constexpr int kBP = pitch_of<T>(kSN), kXP = pitch_of<T>(kSP);
  constexpr int kWB = pitch_of<float>(kSN), kWX = pitch_of<float>(kSP);
  constexpr int kHalves = kChunk / kSK;
  float* dts = reinterpret_cast<float*>(smem);  // [2][kChunk]
  unsigned char* ring = smem + kDtRing;
  float* wide = reinterpret_cast<float*>(ring + 2 * L::kStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = nt * kSN, p0 = pt * kSP;
  const float ah = a[h];
  const T* bb = bm + b * st.b_b + n0;
  const T* xb = x + b * st.x_b + h * st.x_h + p0;
  auto panels = [&](int g, Panel<T>& pb, Panel<T>& px) {
    const int t0 = g * kSK;
    pb = Panel<T>{bb + t0 * st.b_l, st.b_l, kSK, kSN, d.len - t0, d.ns - n0};
    px = Panel<T>{xb + t0 * st.x_l, st.x_l, kSK, kSP, d.len - t0, d.np - p0};
  };
  auto load_half = [&](int g) {
    unsigned char* stage = ring + (g & 1) * L::kStage;
    Panel<T> pb, px;
    panels(g, pb, px);
    if (g % kHalves == 0) {
      const int c = g / kHalves, t0 = c * kChunk;
      load_dt<kAsync>(dt, b * st.dt_b + t0 * st.dt_l + h * st.dt_h,
                       st.dt_l, d.len - t0, dts + (c & 1) * kChunk);
    }
    load_panel<kAsync>(pb, reinterpret_cast<T*>(stage), kBP);
    load_panel<kAsync>(px, reinterpret_cast<T*>(stage + L::kB), kXP);
  };

  // rows n0 + ng * 4 + i, columns p0 + pg * 4 + j
  const int pg = lane & 7, ng = warp * 4 + (lane >> 3);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const long long bh = static_cast<long long>(b) * d.nh + h;
  const int plane = d.ns * d.p_pad;
  const int halves = d.chunks * kHalves;
  float w0 = 0.0f, w1 = 0.0f;  // dt exp(cum_last - cum) at 2 lane, 2 lane + 1
  if (halves > 0) load_half(0);
  cp_async_commit();
  for (int g = 0; g < halves; ++g) {
    cp_async_wait<0>();
    __syncthreads();  // half g has landed; half g - 1 is consumed
    if (g + 1 < halves) load_half(g + 1);
    cp_async_commit();
    const int c = g / kHalves, half = g % kHalves;
    if (half == 0) {
      const float* dc = dts + (c & 1) * kChunk;
      float cum0, cum1;
      chunk_cumsum(dc, ah, cum0, cum1);
      const float last = __shfl_sync(0xffffffffu, cum1, 31);
      w0 = dc[2 * lane] * expf(last - cum0);
      w1 = dc[2 * lane + 1] * expf(last - cum1);
      if (c > 0) {  // the state this chunk starts from
        float* out = states + (bh * d.chunks + c) * plane;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + ng * 4 + i, p = p0 + pg * 4;
          if (n < d.ns && p < d.p_pad)
            *reinterpret_cast<float4*>(out + n * d.p_pad + p) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      const float e = expf(last);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
    }
    unsigned char* stage = ring + (g & 1) * L::kStage;
    Panel<T> pb, px;
    panels(g, pb, px);
    T* braw = reinterpret_cast<T*>(stage);
    T* xraw = reinterpret_cast<T*>(stage + L::kB);
    const float* bw = reinterpret_cast<const float*>(braw);
    float* xw = reinterpret_cast<float*>(xraw);
    if constexpr (sizeof(T) != 4) {
      widen(pb, braw, kBP, wide, kWB, One{});
      bw = wide;
      xw = wide + kSK * kWB;
    }
    // x row r is position u = half * kSK + r, whose weight lane u / 2
    // holds; every thread widens as many chunks (the shuffles need all 32)
    constexpr int kPer = kSP / vec_of<T>();
    static_assert(kSK * kPer % kThreads == 0, "");
    for (int i = tid; i < kSK * kPer; i += kThreads) {
      const int r = i / kPer, col = (i - r * kPer) * vec_of<T>();
      const int u = half * kSK + r;
      const float lo = __shfl_sync(0xffffffffu, w0, u >> 1);
      const float hi = __shfl_sync(0xffffffffu, w1, u >> 1);
      widen_chunk(xraw + r * kXP + col, xw + r * kWX + col,
                  (u & 1) ? hi : lo);
    }
    __syncthreads();
    mm_outer<kSK>(acc, bw, kWB, xw, kWX, ng * 4, pg * 4);
  }

  float* so = state_out + bh * d.ns * d.np;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ng * 4 + i;
    if (n >= d.ns) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + pg * 4 + j;
      if (p < d.np) so[static_cast<long long>(n) * d.np + p] = acc[i][j];
    }
  }
}

// y of one (b, chunk, h) for 64 columns of P: exp(cum_t) C_t S_in over the
// state rows (none for the first chunk), then the decay-masked C B^T times
// x over the chunk's positions.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kYThreads)
ssd_y_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a, const T* __restrict__ cm,
             const float* __restrict__ states,
             const float* __restrict__ gmat, T* __restrict__ y, Dims d,
             Strides st) {
  using L = YLayout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  int blk = blockIdx.x;
  const int pt = blk % d.p_tiles;
  blk /= d.p_tiles;
  const int h = blk % d.nh;
  blk /= d.nh;
  const int c = blk % d.chunks;
  const int b = blk / d.chunks;

  constexpr int kCP = pitch_of<T>(kYK), kGP = pitch_of<float>(kYK);
  constexpr int kSP2 = pitch_of<float>(kYP), kXP = pitch_of<T>(kYP);
  float* dts = reinterpret_cast<float*>(smem);
  float* cum = dts + kChunk;
  float* ecum = cum + kChunk;
  unsigned char* ring = smem + kHead;
  float* wide = reinterpret_cast<float*>(ring + 2 * L::kStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * kChunk, p0 = pt * kYP;
  const int live = d.len - t0;
  const long long bh = static_cast<long long>(b) * d.nh + h;
  const T* cb = cm + b * st.c_b + t0 * st.c_l;
  const T* xb = x + b * st.x_b + t0 * st.x_l + h * st.x_h + p0;
  const float* sb = states + (bh * d.chunks + c) * d.ns * d.p_pad + p0;
  const float* gb =
      gmat + (static_cast<long long>(b) * d.chunks + c) * kChunk * kChunk;
  const int inter = c > 0 ? (d.ns + kYK - 1) / kYK : 0;
  const int slices = inter + kChunk / kYK;

  auto load_slice = [&](int s) {
    unsigned char* stage = ring + (s & 1) * L::kStage;
    if (s < inter) {
      const int n0 = s * kYK;
      load_panel<kAsync>(Panel<T>{cb + n0, st.c_l, kChunk, kYK, live, d.ns - n0},
                    reinterpret_cast<T*>(stage), kCP);
      load_panel<true>(Panel<float>{sb + static_cast<long long>(n0) * d.p_pad,
                               d.p_pad, kYK, kYP, d.ns - n0, d.p_pad - p0},
                  reinterpret_cast<float*>(stage + L::kA), kSP2);
    } else {
      const int u0 = (s - inter) * kYK;
      load_panel<true>(Panel<float>{gb + u0, kChunk, kChunk, kYK, kChunk, kYK},
                  reinterpret_cast<float*>(stage), kGP);
      load_panel<kAsync>(Panel<T>{xb + u0 * st.x_l, st.x_l, kYK, kYP, live - u0,
                             d.np - p0},
                    reinterpret_cast<T*>(stage + L::kA), kXP);
    }
  };

  load_dt<kAsync>(dt, b * st.dt_b + t0 * st.dt_l + h * st.dt_h, st.dt_l,
                   live, dts);
  load_slice(0);
  cp_async_commit();

  const int pg = lane & 15, tg = warp * 2 + (lane >> 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load_slice(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (s == 0) {
      __syncthreads();  // dt has landed
      if (warp == 0) {
        float cum0, cum1;
        chunk_cumsum(dts, a[h], cum0, cum1);
        cum[2 * lane] = cum0;
        cum[2 * lane + 1] = cum1;
        ecum[2 * lane] = expf(cum0);
        ecum[2 * lane + 1] = expf(cum1);
      }
      __syncthreads();
    }
    unsigned char* stage = ring + (s & 1) * L::kStage;
    // the float32 tiles the products read: A (C, or C B^T decayed) at
    // pitch kGP, B (S_in, or x) at pitch kSP2, in place or widened
    const float* pa = reinterpret_cast<const float*>(stage);
    const float* pb = reinterpret_cast<const float*>(stage + L::kA);
    int kn = kYK;
    if (s < inter) {
      const int n0 = s * kYK;
      if constexpr (sizeof(T) != 4) {
        widen(Panel<T>{cb + n0, st.c_l, kChunk, kYK, live, d.ns - n0},
              reinterpret_cast<const T*>(stage), kCP, wide, kGP, One{});
        pa = wide;
      }
    } else {
      const int u0 = (s - inter) * kYK;
      float* g = reinterpret_cast<float*>(stage);
      // the decay exp(cum_t - cum_u) dt_u where u <= t; 0 above the diagonal
      widen(Panel<float>{gb + u0, kChunk, kChunk, kYK, kChunk, kYK}, g, kGP,
            g, kGP, [cum, dts, u0](int t, int j) {
              const int u = u0 + j;
              return u <= t ? expf(cum[t] - cum[u]) * dts[u] : 0.0f;
            });
      if constexpr (sizeof(T) != 4) {
        widen(Panel<T>{xb + u0 * st.x_l, st.x_l, kYK, kYP, live - u0,
                       d.np - p0},
              reinterpret_cast<const T*>(stage + L::kA), kXP,
              wide + kChunk * kGP, kSP2, One{});
        pb = wide + kChunk * kGP;
      }
      // this warp's rows end at 8 warp + 7: later positions add nothing
      kn = min(kYK, 8 * warp + 8 - u0);
    }
    __syncthreads();
    if (kn > 0) mm_rows<4, kYK, kGP, kSP2>(acc, pa, pb, kn, tg * 4, pg * 4);
    if (s + 1 == inter) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= ecum[tg * 4 + i];
    }
    __syncthreads();
  }

  const bool vec = d.np % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tg * 4 + i;
    if (t >= d.len) continue;
    T* row = y + ((static_cast<long long>(b) * d.len + t) * d.nh + h) * d.np;
    const int p = p0 + pg * 4;
    if (vec && p < d.np) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(row + p) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
        uint2 v;
        v.x = *reinterpret_cast<unsigned*>(&lo);
        v.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(row + p) = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p + j < d.np) store(row + p + j, acc[i][j]);
    }
  }
}

// ---------------------------------------------------- the first version

// One block of 256 threads per (b, h, 64 columns of P) walks the chunks in
// series with the (N, 64) state in shared memory; C B^T is recomputed by
// every head. Kept only as the partner the smoke run times in turns with
// the kernels above (ssd_scan_serial_launch).
constexpr int kPT = 64;        // columns of P per block
constexpr int kNT = 32;        // state rows per staged slice of B and C
constexpr int kSerialThreads = 256;  // a 16 x 16 grid
constexpr int kBP = kNT + 1;   // row pitch of the B and C slices
constexpr int kGP1 = kChunk + 1;  // row pitch of C B^T

size_t serial_smem_floats(int n_pad) {
  return static_cast<size_t>(kChunk) * kPT + static_cast<size_t>(n_pad) * kPT +
         2 * static_cast<size_t>(kChunk) * kBP +
         static_cast<size_t>(kChunk) * kGP1 + 4 * static_cast<size_t>(kChunk);
}

template <typename T>
__global__ void __launch_bounds__(kSerialThreads)
ssd_serial_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, T* __restrict__ y,
                  float* __restrict__ state_out, int len, int nh, int np,
                  int ns, int n_pad, Strides st) {
  extern __shared__ float smem1[];
  float* xs = smem1;                  // [kChunk][kPT]
  float* ss = xs + kChunk * kPT;      // [n_pad][kPT]
  float* bs = ss + n_pad * kPT;       // [kChunk][kBP]
  float* cs = bs + kChunk * kBP;      // [kChunk][kBP]
  float* gs = cs + kChunk * kBP;      // [kChunk][kGP1]
  float* dts = gs + kChunk * kGP1;    // [kChunk]
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

  for (int i = tid; i < n_pad * kPT; i += kSerialThreads) ss[i] = 0.0f;

  const int n_chunks = (len + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    __syncthreads();  // the previous chunk is consumed (the state is zeroed)
    for (int i = tid; i < kChunk * kPT; i += kSerialThreads) {
      const int u = i / kPT;
      const int pp = i - u * kPT;
      xs[i] = (t0 + u < len && p0 + pp < np)
                  ? to_float(xb[(t0 + u) * st.x_l + pp])
                  : 0.0f;
    }
    if (tid < kChunk) {
      const float dv = (t0 + tid < len) ? dtb[(t0 + tid) * st.dt_l] : 0.0f;
      dts[tid] = dv;
      // inclusive scan of a * dt within each of the two warps
      float v = ah * dv;
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
      for (int i = tid; i < kChunk * kNT; i += kSerialThreads) {
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
        gs[t * kGP1 + u] =
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
      for (int i = 0; i < 4; ++i) gr[i] = gs[(ty + 16 * i) * kGP1 + u];
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
  for (int i = tid; i < ns * kPT; i += kSerialThreads) {
    const int n = i / kPT;
    const int pp = i - n * kPT;
    if (p0 + pp < np) so[static_cast<long long>(n) * np + p0 + pp] =
        ss[n * kPT + pp];
  }
}

// ------------------------------------------------------------------ host

// Raise a kernel's dynamic shared memory limit once per (kernel, device,
// bytes): `done` is the kernel's own (one per instantiation of
// allow_smem_once, whose template argument is the kernel itself).
cudaError_t allow_smem(const void* kernel, int bytes,
                       std::atomic<int>* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load() == bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[device].store(bytes);
  return err;
}

template <auto kKernel>
cudaError_t allow_smem_once(int bytes) {
  static std::atomic<int> done[kMaxDevices];
  return allow_smem(reinterpret_cast<const void*>(kKernel), bytes, done);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

long long round256(long long n) { return (n + 255) / 256 * 256; }

// The workspace: the state each chunk starts from [B, H, chunks, N, P
// rounded up to 4] (chunk 0's slot unused), then C B^T [B, chunks, 64, 64],
// float32, the second part starting on 256 bytes.
struct Workspace {
  long long gmat, bytes;  // the offset of C B^T, the total
};

Workspace workspace_of(const Dims& d) {
  Workspace w;
  w.gmat = round256(4LL * d.n_batch * d.nh * d.chunks * d.ns * d.p_pad);
  w.bytes = w.gmat + 4LL * d.n_batch * d.chunks * kChunk * kChunk;
  return w;
}

template <typename T, bool kAsync>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, void* y, float* state, unsigned char* work,
           const Dims& d, const Strides& st, cudaStream_t stream) {
  const Workspace w = workspace_of(d);
  float* states = reinterpret_cast<float*>(work);
  float* gmat = reinterpret_cast<float*>(work + w.gmat);
  int bytes = StateLayout<T>::kBytes;
  cudaError_t err = allow_smem_once<&ssd_state_kernel<T, kAsync>>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = static_cast<long long>(d.n_batch) *
                     (d.chunks + static_cast<long long>(d.nh) * d.s_tiles *
                                     d.n_tiles);
  ssd_state_kernel<T, kAsync><<<static_cast<unsigned>(blocks),
                                kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), states, gmat, state, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.chunks == 0) return static_cast<int>(err);
  bytes = YLayout<T>::kBytes;
  err = allow_smem_once<&ssd_y_kernel<T, kAsync>>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blocks = static_cast<long long>(d.n_batch) * d.chunks * d.nh * d.p_tiles;
  ssd_y_kernel<T, kAsync><<<static_cast<unsigned>(blocks), kYThreads,
                            bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(cm), states,
      gmat, static_cast<T*>(y), d, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, void* y, float* state,
               unsigned char* work, const Dims& d, const Strides& st,
               cudaStream_t stream) {
  // cp.async takes 16-byte aligned chunks: every row start of x, B and C
  constexpr long long kV = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(bm) && aligned16(cm) &&
                   st.x_b % kV == 0 && st.x_l % kV == 0 && st.x_h % kV == 0 &&
                   st.b_b % kV == 0 && st.b_l % kV == 0 &&
                   st.c_b % kV == 0 && st.c_l % kV == 0;
  return vec ? launch<T, true>(x, dt, a, bm, cm, y, state, work, d, st,
                               stream)
             : launch<T, false>(x, dt, a, bm, cm, y, state, work, d, st,
                                stream);
}

Dims dims_of(int n_batch, int len, int nh, int np, int ns) {
  Dims d;
  d.n_batch = n_batch;
  d.len = len;
  d.nh = nh;
  d.np = np;
  d.ns = ns;
  d.chunks = (len + kChunk - 1) / kChunk;
  d.p_tiles = (np + kYP - 1) / kYP;
  d.s_tiles = (np + kSP - 1) / kSP;
  d.n_tiles = (ns + kSN - 1) / kSN;
  d.p_pad = (np + 3) / 4 * 4;
  return d;
}

template <typename T>
int launch_serial(const void* x, const float* dt, const float* a,
                  const void* bm, const void* cm, void* y, float* state,
                  int n_batch, int len, int nh, int np, int ns,
                  const Strides& st, cudaStream_t stream) {
  const int n_pad = (ns + kNT - 1) / kNT * kNT;
  const int bytes = static_cast<int>(serial_smem_floats(n_pad) * sizeof(float));
  const cudaError_t set = allow_smem_once<&ssd_serial_kernel<T>>(bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((np + kPT - 1) / kPT, nh, n_batch);
  ssd_serial_kernel<T><<<grid, kSerialThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), state, len, nh, np, ns,
      n_pad, st);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int n_batch, int len, int nh, int np, int ns) {
  return ns >= 1 && ns <= kMaxState && n_batch >= 0 && len >= 0 && nh >= 0 &&
         np >= 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of x, B, C and y); dt and a are float32.
// x is [B, L, H, P] given by its (b, l, h) strides, dt [B, L, H] by its
// (b, l, h) strides, B and C [B, L, N] by their (b, l) strides, each in
// elements with the last dimension contiguous; y is contiguous
// [B, L, H, P] and the state contiguous [B, H, N, P]. 1 <= N <= 256.
// `work` holds work_bytes bytes (workspace_of), and
// state_smem / y_smem are the shared bytes the caller's plan expects of
// the state and y kernels: a launch whose numbers differ is refused.
// Returns a cudaError_t code (0 on success).
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, void* y, void* state, void* work, long long work_bytes,
    int state_smem, int y_smem, int n_batch, int len, int nh, int np, int ns,
    long long x_b, long long x_l, long long x_h, long long dt_b,
    long long dt_l, long long dt_h, long long b_b, long long b_l,
    long long c_b, long long c_l, void* stream) {
  if (!valid_shape(n_batch, len, nh, np, ns) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch == 0 || nh == 0 || np == 0) return 0;
  const Dims d = dims_of(n_batch, len, nh, np, ns);
  const bool f32 = dtype == 0;
  if (workspace_of(d).bytes != work_bytes ||
      state_smem != (f32 ? StateLayout<float>::kBytes
                         : StateLayout<__nv_bfloat16>::kBytes) ||
      y_smem != (f32 ? YLayout<float>::kBytes : YLayout<__nv_bfloat16>::kBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_b, x_l, x_h, dt_b, dt_l, dt_h, b_b, b_l, c_b, c_l};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  unsigned char* wk = static_cast<unsigned char*>(work);
  if (f32)
    return launch_any<float>(x, dtf, af, bm, cm, y, sf, wk, d, st, s);
  return launch_any<__nv_bfloat16>(x, dtf, af, bm, cm, y, sf, wk, d, st, s);
}

// The first version (ssd_serial_kernel), same operands, no workspace.
extern "C" int ssd_scan_serial_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, void* y, void* state, int n_batch, int len, int nh,
    int np, int ns, long long x_b, long long x_l, long long x_h,
    long long dt_b, long long dt_l, long long dt_h, long long b_b,
    long long b_l, long long c_b, long long c_l, void* stream) {
  if (!valid_shape(n_batch, len, nh, np, ns) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch == 0 || nh == 0 || np == 0) return 0;
  const Strides st{x_b, x_l, x_h, dt_b, dt_l, dt_h, b_b, b_l, c_b, c_l};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return launch_serial<float>(x, dtf, af, bm, cm, y, sf, n_batch, len, nh,
                                np, ns, st, s);
  return launch_serial<__nv_bfloat16>(x, dtf, af, bm, cm, y, sf, n_batch,
                                      len, nh, np, ns, st, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
