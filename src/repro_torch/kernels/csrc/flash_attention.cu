// Blocked online-softmax GQA attention for Hopper (sm_90a), plain C
// interface: the prefill path's causal (or bidirectional) attention. It
// replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).
//
//     o[b, h, i] = softmax_j(q[b, h, i] . k[b, g, j] * scale) @ v[b, g, j]
//
// with g = h / rep, over keys j < lk and, when causal, j <= i + (lk - lq):
// the queries sit at the end of the lk-long context. float32 running max,
// sum and accumulator whatever the storage type, with the reference's
// masking: a masked score is -1e30, its weight is zeroed AFTER the exp, and
// the output divides by the sum where it is not 0, else by 1 (a query row
// with no visible key gives 0). What bounds it on an H100 is operations,
// 4 * D per visible (query, key) pair and head: at 67 TFLOP/s in float32,
// at 989 TFLOP/s on the bfloat16 tensor cores.
//
// Two kernels on the path, one per storage type; each type reaches exactly
// one. A third, the first float32 version, is kept off the path.
//
// float32, flash_attention_kernel: float32 FMAs (TF32 tensor cores would
// round the inputs to 10 mantissa bits, above float32's tolerance). A
// warp-wide float4 read of shared memory hands 512 bytes to the lanes, 4 of
// the SM's 128 bytes a clock, and 4 warp FMAs issue a clock: so the kernel
// is held by how many FMAs each float4 read feeds (16 to keep up), which
// the size of each thread's register tile sets. One block of 128 threads
// per (b * Hq + h, tile of 64 queries), 2 blocks (8 warps) an SM: 112 KB of
// shared memory at D 128. Blocks go out with every head's last query tile
// (the longest causal rows) first, so the short tiles fill the last wave.
// Thread (ry, kx), ry < 8, kx < 16, owns query rows ry + 8 i (i < 8): it
// scores them against keys kx + 16 j (j < 4) of a 64-key tile (12 float4
// reads per 128 FMAs) and accumulates their outputs over the 16-byte
// column chunks kx + 16 c of D (16 reads per 256 FMAs at D 128), so a
// row's max and sum stay with the 16 lanes of its group (four shuffles).
// Q and K tiles are row-major in shared memory without padding, their
// 16-byte chunks permuted by the row's low 3 bits, so the rows a warp
// reads at one chunk fall on distinct banks; V is read along rows. The
// weights go to shared memory (chunks permuted by row parity) and come back
// 4 keys per float4. Q is copied once; one K and one V buffer take 16-byte
// cp.async.cg copies (a source size of 0 zero-fills rows past lq or lk),
// V(t) in flight while S(t) is computed and K(t + 1) while P V(t) is: two
// barriers per tile. Scores are scaled into units of log2 and exponentiated
// with ex2.approx. Tiles wholly past the causal frontier are never loaded, only
// a tile that crosses the frontier or lk computes a mask, and rows whose
// max did not move skip the rescale. The tile sizes, shared bytes and grid
// are also computed by the host plan (flash_f32_plan in
// kernels/flash_attention.py); the launcher refuses a plan that differs.
//
// The first float32 version, flash_attention_f32_first_kernel (reached
// only by flash_attention_f32_first_launch, on no path): 64 x 32 tiles
// loaded synchronously through registers into shared memory, scalar reads
// (2 FMAs per shared-memory wavefront in the score loop), 3 blocks an SM,
// blocks in query order. It stays as the partner the smoke run times the
// new kernel against, and its output digests pin it.
//
// bfloat16, flash_attention_bf16_kernel: FlashAttention-2's structure on
// the tensor cores through mma.sync.m16n8k16 (bf16 operands, float32
// accumulators). One block of 4 warps per (b * Hq + h, tile of 64 queries),
// each warp owning 16 query rows; every head's last query tile (the
// longest causal rows) goes out first, so the short tiles fill the last
// wave. Q is copied once (cp.async -> shared -> ldmatrix) into registers
// as A fragments for all of D. K/V tiles of 64 keys stream through a
// 2-stage cp.async ring (16-byte cp.async.cg copies, one commit group per
// tile): the next tile's copy is in flight while the current one is
// computed on. Shared rows are padded by 16 bytes, so the 8 row addresses
// of every ldmatrix fall on distinct banks. S = Q K^T goes through
// ldmatrix'd K fragments; the online softmax runs in registers (row max
// reduced over the 4 lanes that share a row with __shfl_xor_sync, weights
// as exp2f(x log2(e) - m log2(e)) of the scaled scores x, per-lane partial
// row sums reduced once at the end); P is re-packed from the S
// accumulators into bf16 A fragments without a trip through shared
// memory, and O += P V goes through ldmatrix.trans'd V fragments. P is
// rounded to bfloat16 there, as SDPA's kernels do; the float32 plain
// version does not, which the 2e-2 bfloat16 tolerance covers. Rows past lq
// or lk are zero-filled by the copies (cp.async with a source size of 0)
// and masked by position; tiles wholly past the causal frontier are never
// loaded, and only tiles that cross the frontier or lk compute a mask. The
// epilogue divides by the sum, rounds to bfloat16 and stores through
// shared memory as 16-byte writes.
// Not yet: wgmma, TMA, warp specialisation, a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
flash_attention_f32_first_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ out,
                                 int hq, int hkv, int lq, int lk, int causal,
                                 float scale, Strides st) {
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
int launch_first(const void* q, const void* k, const void* v, void* out,
                 int n_batch, int hq, int hkv, int lq, int lk, int causal,
                 float scale, const Strides& st, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_f32_first_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((lq + kBQ - 1) / kBQ, n_batch * hq);
  flash_attention_f32_first_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, lq, lk,
      causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBQ = 16 * kMmaWarps;  // queries per block, 16 per warp
constexpr int kMmaBK = 64;              // keys per tile
constexpr int kStages = 2;              // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// Shared row pitch in bf16 elements: D plus 16 bytes, so that the 8 rows an
// ldmatrix reads start 4 banks apart (mod 32) and never share a bank.
template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * pitch<D>() *
         (static_cast<size_t>(kMmaBQ) + 2 * kStages * kMmaBK);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  // a source size of 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 bf16 A fragment (4 registers), a 16 x 8 bf16 B
// fragment (2 registers), a 16 x 8 float32 accumulator (4 registers).
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Copy rows [row0, row0 + n_rows) of one head ([L, D] with row stride
// `row_stride` elements) into a shared tile of pitch<D>(); rows at or past
// `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_rows, int limit) {
  constexpr int nv = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n_rows * nv; i += kMmaThreads) {
    const int r = i / nv;
    const int c = (i - r * nv) * 8;
    const bool live = row0 + r < limit;
    const __nv_bfloat16* g = live ? src + (row0 + r) * row_stride + c : src;
    cp_async16(dst + r * pitch<D>() + c, g, live);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int hq, int hkv,
                            int lq, int lk, int causal, float scale,
                            Strides st) {
  constexpr int P = pitch<D>();
  constexpr int kSteps = D / 16;      // k-steps of Q K^T; n-pairs of P V
  constexpr int kNt = kMmaBK / 8;     // n-tiles of S (8 keys each)
  constexpr int kDt = D / 8;          // n-tiles of O (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * P;                  // [kStages][BK][P]
  __nv_bfloat16* vs = ks + kStages * kMmaBK * P;        // [kStages][BK][P]

  // blocks go out x fastest: every head's last query tile (the longest
  // causal rows) first, then the tile before it, and so on
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int g = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // row within the 8-row half of a fragment
  const int tig = lane & 3;   // thread in the row's group of 4
  const int offset = lk - lq;

  const __nv_bfloat16* qh = q + b * st.q_b + h * st.q_h;
  const __nv_bfloat16* kh = k + b * st.k_b + g * st.k_h;
  const __nv_bfloat16* vh = v + b * st.v_b + g * st.v_h;

  int k_end = lk;
  if (causal) k_end = min(lk, min(q0 + kMmaBQ, lq) + offset);
  const int n_tiles = k_end > 0 ? (k_end + kMmaBK - 1) / kMmaBK : 0;

  // one commit group per K/V tile (the first also holds Q), and one per
  // loop step whether or not it copies anything, so that waiting for all
  // but the newest kStages - 1 groups always means tile t has landed
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      const int at = (t % kStages) * kMmaBK * P;
      copy_tile<D>(ks + at, kh, st.k_l, t * kMmaBK, kMmaBK, lk);
      copy_tile<D>(vs + at, vh, st.v_l, t * kMmaBK, kMmaBK, lk);
    }
    cp_async_commit();
  };
  copy_tile<D>(qs, qh, st.q_l, q0, kMmaBQ, lq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  cp_async_wait<kStages - 2>();  // Q (and tile 0)
  __syncthreads();

  // this warp's 16 query rows as A fragments for every k-step of D
  unsigned qf[kSteps][4];
  {
    const __nv_bfloat16* base = qs + (warp * 16 + (lane & 15)) * P +
                                8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], base + 16 * kk);
  }

  float o[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // rows gid and gid + 8, scaled scores
  float l[2] = {0.0f, 0.0f};        // this lane's part of the row sums
  const int row_a = q0 + warp * 16 + gid;  // query index of row gid

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kMmaBK;
    const int stage = t % kStages;
    fetch(t + kStages - 1);  // in flight while tiles t.. are computed on
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * kMmaBK * P;
    const __nv_bfloat16* vt = vs + stage * kMmaBK * P;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    {
      // matrix (lane >> 3): keys + 8 (mat >> 1), d + 8 (mat & 1)
      const int mat = lane >> 3;
      const __nv_bfloat16* base =
          kt + ((lane & 7) + 8 * (mat >> 1)) * P + 8 * (mat & 1);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int jp = 0; jp < kNt / 2; ++jp) {
          unsigned bf[4];
          ldmatrix_x4(bf, base + 16 * jp * P + 16 * kk);
          mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
        }
      }
    }

    // scale, mask (only a tile that crosses the causal frontier or lk),
    // online softmax; s becomes the weights p
    const bool need_mask =
        k0 + kMmaBK > lk || (causal && k0 + kMmaBK - 1 > q0 + offset);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = row_a + 8 * half + offset;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * half + e] * scale;
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * tig + e;
            if (kpos >= lk || (causal && kpos > qpos)) x = kNegInf;
          }
          s[j][2 * half + e] = x;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[half], mt);
      const float alpha = exp2f((m[half] - m_new) * kLog2e);
      const float m_log2 = m_new * kLog2e;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * half + e];
          // the weight of a masked score is zeroed after the exp
          const float p = x == kNegInf ? 0.0f : exp2f(x * kLog2e - m_log2);
          s[j][2 * half + e] = p;
          rs += p;
        }
      l[half] = l[half] * alpha + rs;
      m[half] = m_new;
#pragma unroll
      for (int j = 0; j < kDt; ++j) {
        o[j][2 * half] *= alpha;
        o[j][2 * half + 1] *= alpha;
      }
    }

    // O += P V: P re-packed from the S accumulators as bf16 A fragments
    {
      // matrix (lane >> 3): keys + 8 (mat & 1), d + 8 (mat >> 1)
      const int mat = lane >> 3;
      const __nv_bfloat16* base =
          vt + ((lane & 7) + 8 * (mat & 1)) * P + 8 * (mat >> 1);
#pragma unroll
      for (int kk = 0; kk < kMmaBK / 16; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kSteps; ++dp) {
          unsigned bf[4];
          ldmatrix_x4_trans(bf, base + 16 * kk * P + 16 * dp);
          mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // row sums over the 4 lanes of each row; divide by 1 where the sum is 0
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[half] = 1.0f / (sum == 0.0f ? 1.0f : sum);
  }
  // stage the warp's rows in the (consumed) Q tile, then 16-byte stores
  __nv_bfloat16* os = qs + (warp * 16 + gid) * P + 2 * tig;
#pragma unroll
  for (int j = 0; j < kDt; ++j) {
    *reinterpret_cast<unsigned*>(os + 8 * j) =
        pack_bf16(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<unsigned*>(os + 8 * P + 8 * j) =
        pack_bf16(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncthreads();
  __nv_bfloat16* oh = out + (static_cast<long long>(bh) * lq) * D;
  constexpr int nv = D / 8;
  for (int i = threadIdx.x; i < kMmaBQ * nv; i += kMmaThreads) {
    const int r = i / nv;
    const int c = (i - r * nv) * 8;
    if (q0 + r < lq)
      *reinterpret_cast<uint4*>(oh + static_cast<long long>(q0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(qs + r * P + c);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int n_batch, int hq, int hkv, int lq, int lk, int causal,
                float scale, const Strides& st, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<D>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(n_batch * hq, (lq + kMmaBQ - 1) / kMmaBQ);
  flash_attention_bf16_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), hq, hkv, lq, lk, causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: FMA kernel, register tiles fed by float4 shared reads
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 64;             // queries per block
constexpr int kF32BK = 64;             // keys per K/V tile
constexpr int kF32Threads = 128;       // 8 row groups x 16 lanes
constexpr int kF32Rows = kF32BQ / 8;   // query rows a thread owns
constexpr int kF32Keys = kF32BK / 16;  // keys a thread scores in a tile

// The Q tile, one K and one V tile (D floats a row) and the weights.
__host__ __device__ constexpr int f32_smem_bytes(int d) {
  return static_cast<int>(sizeof(float)) *
         (kF32BQ * d + 2 * kF32BK * d + kF32BQ * kF32BK);
}

// Float offset of 16-byte chunk `ch` of row `r` in a tile of `w` floats a
// row whose chunks are permuted by the row's low 3 bits: the 8 rows at one
// chunk index land on 8 distinct groups of 4 banks.
__device__ __forceinline__ int swizzled(int r, int ch, int w) {
  return r * w + ((ch ^ (r & 7)) << 2);
}

// Copy kRows rows from row0 of one head ([L, D] with row stride
// `row_stride` elements) into a shared tile of D floats a row, swizzled or
// plain; rows at or past `limit` are zero-filled.
template <int D, int kRows, bool kSwizzle>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* src,
                                              long long row_stride, int row0,
                                              int limit) {
  constexpr int nv = D / 4;  // 16-byte chunks per row
  static_assert(kRows * nv % kF32Threads == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < kRows * nv / kF32Threads; ++n) {
    const int i = threadIdx.x + n * kF32Threads;
    const int r = i / nv;
    const int ch = i - r * nv;
    const bool live = row0 + r < limit;
    const float* g = live ? src + (row0 + r) * row_stride + 4 * ch : src;
    cp_async16(dst + (kSwizzle ? swizzled(r, ch, D) : r * D + 4 * ch), g,
               live);
  }
}

// 2^x, flushing results below 2^-126 to 0 (a weight that small adds nothing
// to a sum whose largest term is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float part(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& x) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int hq, int hkv, int lq, int lk, int causal,
                       float scale, Strides st) {
  constexpr int kChunks = D / 4;            // 16-byte chunks of a row
  constexpr int kOut = (kChunks + 15) / 16;  // O chunks a lane owns, at most
  extern __shared__ __align__(16) float f32_smem[];
  float* qs = f32_smem;          // [BQ][D], swizzled
  float* ks = qs + kF32BQ * D;   // [BK][D], swizzled
  float* vs = ks + kF32BK * D;   // [BK][D]
  float* ps = vs + kF32BK * D;   // [BQ][BK], chunks permuted by row parity

  // blocks go out x fastest: every head's last query tile (the longest
  // causal rows) first, then the tile before it, and so on
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int g = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BQ;
  const int ry = threadIdx.x >> 4;  // rows ry + 8 i of the tile
  const int kx = threadIdx.x & 15;  // keys kx + 16 j, O chunks kx + 16 c
  const int offset = lk - lq;
  const float scale_log2 = scale * kLog2e;  // scores in units of log2

  const float* qh = q + b * st.q_b + h * st.q_h;
  const float* kh = k + b * st.k_b + g * st.k_h;
  const float* vh = v + b * st.v_b + g * st.v_h;

  int k_end = lk;
  if (causal) k_end = min(lk, min(q0 + kF32BQ, lq) + offset);
  const int n_tiles = k_end > 0 ? (k_end + kF32BK - 1) / kF32BK : 0;

  // one K and one V buffer, each copy in flight while the other product
  // runs: V(t) during S(t), K(t + 1) during P V(t); one commit group each
  auto fetch_k = [&](int t) {
    if (t < n_tiles)
      copy_rows_f32<D, kF32BK, true>(ks, kh, st.k_l, t * kF32BK, lk);
    cp_async_commit();
  };
  auto fetch_v = [&](int t) {
    copy_rows_f32<D, kF32BK, false>(vs, vh, st.v_l, t * kF32BK, lk);
    cp_async_commit();
  };
  copy_rows_f32<D, kF32BQ, true>(qs, qh, st.q_l, q0, lq);
  fetch_k(0);

  float4 acc[kF32Rows][kOut];
  float m[kF32Rows], l[kF32Rows];  // l: this lane's part of the row sum
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int pswz = (ry & 1) << 2;  // the weights' chunk permutation

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kF32BK;
    cp_async_wait<0>();  // K(t) (and Q) landed for this thread's copies
    __syncthreads();     // ... for every thread's; P V(t - 1) is done
    fetch_v(t);

    // S = Q K^T: 8 query rows x 4 keys a thread, float4 along D; the 8
    // rows share their swizzle (ry & 7), the 4 keys theirs (kx & 7)
    float s[kF32Rows][kF32Keys];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j) s[i][j] = 0.0f;
#pragma unroll 1
    for (int ch = 0; ch < kChunks; ++ch) {
      float4 kv[kF32Keys];
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            ks + swizzled(kx + 16 * j, ch, D));
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + swizzled(ry + 8 * i, ch, D));
#pragma unroll
        for (int j = 0; j < kF32Keys; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // scale, mask (only a tile that crosses the causal frontier or lk),
    // online softmax over the 16 lanes of each row; weights to shared
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j) s[i][j] *= scale_log2;
    if (k0 + kF32BK > lk || (causal && k0 + kF32BK - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const int qpos = q0 + ry + 8 * i + offset;
#pragma unroll
        for (int j = 0; j < kF32Keys; ++j) {
          const int kpos = k0 + kx + 16 * j;
          if (kpos >= lk || (causal && kpos > qpos)) s[i][j] = kNegInf;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int row = ry + 8 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j) mt = fmaxf(mt, s[i][j]);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = exp2_ftz(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j) {
        // the weight of a masked score is zeroed after the exp
        const float p =
            s[i][j] == kNegInf ? 0.0f : exp2_ftz(s[i][j] - m_new);
        ps[row * kF32BK + ((((kx >> 2) + 4 * j) ^ pswz) << 2) + (kx & 3)] =
            p;
        rs += p;
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      if (alpha != 1.0f) {
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          acc[i][c].x *= alpha;
          acc[i][c].y *= alpha;
          acc[i][c].z *= alpha;
          acc[i][c].w *= alpha;
        }
      }
    }
    cp_async_wait<0>();  // V(t) landed for this thread's copies
    __syncthreads();     // ... for every thread's; S(t) is done with K
    fetch_k(t + 1);

    // O += P V: 4 keys' weights of a row per float4, V rows along D
#pragma unroll 2
    for (int t4 = 0; t4 < kF32BK; t4 += 4) {
      float4 pv[kF32Rows];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (ry + 8 * i) * kF32BK + (((t4 >> 2) ^ pswz) << 2));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 vv[kOut];
#pragma unroll
        for (int c = 0; c < kOut; ++c)
          if (kx + 16 * c < kChunks)
            vv[c] = *reinterpret_cast<const float4*>(
                vs + (t4 + e) * D + 4 * (kx + 16 * c));
#pragma unroll
        for (int i = 0; i < kF32Rows; ++i) {
          const float p = part(pv[i], e);
#pragma unroll
          for (int c = 0; c < kOut; ++c)
            if (kx + 16 * c < kChunks) fma4(acc[i][c], p, vv[c]);
        }
      }
    }
  }

  // row sums over the 16 lanes of each row; divide by 1 where the sum is 0
  float* oh = out + (static_cast<long long>(bh) * lq) * D;
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    float sum = l[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int row = q0 + ry + 8 * i;
    if (row >= lq) continue;
    const float div = sum == 0.0f ? 1.0f : sum;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      if (kx + 16 * c >= kChunks) continue;
      const float4 a = acc[i][c];
      *reinterpret_cast<float4*>(oh + static_cast<long long>(row) * D +
                                 4 * (kx + 16 * c)) =
          make_float4(a.x / div, a.y / div, a.z / div, a.w / div);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int n_batch, int hq, int hkv, int lq, int lk, int causal,
               float scale, const Strides& st, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes(D);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(n_batch * hq, (lq + kF32BQ - 1) / kF32BQ);
  flash_attention_kernel<D><<<grid, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, lq,
      lk, causal, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, D>{}) for the head dims the kernels take
template <typename F>
int with_head_dim(int d, F&& f) {
  switch (d) {
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 96:
      return f(std::integral_constant<int, 96>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32 (flash_attention_kernel), 1 bfloat16
// (flash_attention_bf16_kernel); d in {32, 64, 96, 128}. q is
// [B, Hq, Lq, D] and k, v are [B, Hkv, Lk, D], each given by its (b, h, l)
// strides in elements with D contiguous, rows starting on 16 bytes; out is
// contiguous [B, Hq, Lq, D]. block_q, block_k and smem_bytes are the
// caller's float32 plan: a float32 launch whose numbers differ from the
// kernel's layout is refused; a bfloat16 launch takes 0 for each. Returns a
// cudaError_t code (0 on success).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int n_batch, int hq, int hkv, int lq, int lk, int d, int causal,
    float scale, long long q_b, long long q_h, long long q_l, long long k_b,
    long long k_h, long long k_l, long long v_b, long long v_h,
    long long v_l, int block_q, int block_k, int smem_bytes, void* stream) {
  const bool f32 = dtype == 0;
  const bool planned = f32 ? block_q == kF32BQ && block_k == kF32BK &&
                                 smem_bytes == f32_smem_bytes(d)
                           : block_q == 0 && block_k == 0 && smem_bytes == 0;
  if ((dtype != 0 && dtype != 1) || !planned)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch <= 0 || hq <= 0 || lq <= 0) return 0;
  const Strides st{q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return f32 ? launch_f32<D>(q, k, v, out, n_batch, hq, hkv, lq, lk, causal,
                               scale, st, s)
               : launch_bf16<D>(q, k, v, out, n_batch, hq, hkv, lq, lk,
                                causal, scale, st, s);
  });
}

// The first float32 version (flash_attention_f32_first_kernel), same
// operands as a float32 flash_attention_launch, no plan.
extern "C" int flash_attention_f32_first_launch(
    const void* q, const void* k, const void* v, void* out, int n_batch,
    int hq, int hkv, int lq, int lk, int d, int causal, float scale,
    long long q_b, long long q_h, long long q_l, long long k_b, long long k_h,
    long long k_l, long long v_b, long long v_h, long long v_l,
    void* stream) {
  if (n_batch <= 0 || hq <= 0 || lq <= 0) return 0;
  const Strides st{q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch_first<float, D>(q, k, v, out, n_batch, hq, hkv, lq, lk,
                                  causal, scale, st, s);
  });
}

// Resident blocks per SM of flash_attention_kernel at head dim d, from the
// occupancy calculator, into *out.
extern "C" int flash_attention_f32_blocks_per_sm(int d, int* out) {
  return with_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, f32_smem_bytes(D));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, flash_attention_kernel<D>, kF32Threads, f32_smem_bytes(D));
    return static_cast<int>(err);
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
