// GQA KV-cache decode attention for Hopper (sm_90a), plain C interface. It
// replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel).
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
// What bounds it on an H100 is bytes: the live K/V rows, read once, at
// 3.35 TB/s. Even at rep = 3 the FMAs are a small share of the float32
// rate at that byte rate, so it computes on the CUDA cores in float32.
//
// Design ("flash-decoding"): the live prefix of each sequence is split over
// blocks. Block ((b * Hkv + g) * n_hg + i, j) serves query heads
// [i * hpb, min(rep, (i + 1) * hpb)) of kv group g over positions
// [j * split_len, (j + 1) * split_len). hpb, the heads per block, is all
// rep heads wherever their float32 q rows and p @ V sums fit a block (the
// accumulator limit below and 227 KB of shared memory): then n_hg = 1 and
// each K/V row is read once per sequence, the property the TPU kernel was
// built around. Past that (MLA's absorbed decode: rep 128 over one latent
// head at D 576) hpb is the largest multiple of kHeads that fits, and the
// n_hg = ceil(rep / hpb) head groups each read the kv group's rows; heads
// past rep in the last group are left out. The host picks hpb, split_len
// and the number of splits from the shapes alone
// (repro_torch/kernels/decode_attention.py::decode_plan), so nothing on
// the device is read back, and the launcher refuses a plan that differs
// from its own. A split that starts at or past the sequence's
// length writes an empty partial and returns: stale rows past a length are
// never read. Inside a block, tiles of kTile positions stream through a
// ring of kStages shared-memory stages in their storage type (a K and a V
// tile per stage, or one tile where K and V are one tensor), by 16-byte
// cp.async.cg copies, one commit group per tile, so the next tiles load
// while the current one is computed on; rows past the split's live end are
// zero-filled (source size 0) and masked by position. Scores and products
// are float32 FMAs on the CUDA cores. On each tile:
//   scores  a group of 8 lanes dots 2 positions with 4 heads at a time:
//           each lane reads 16-byte chunks of the K rows (the 8 lanes of a
//           group read 128 contiguous bytes of a row, so no bank conflict),
//           widens each once for all 4 heads, and takes q's rows from
//           shared memory, where they are kept as float32; the group's 8
//           lanes then reduce-scatter their 8 sums in 7 shuffles, each lane
//           ending with one whole dot product;
//   softmax one warp per head updates the running max and sum and turns
//           the tile's scores into weights;
//   p @ V   each thread owns one or more units of (4 heads, one 16-byte
//           chunk of D), widens each V chunk once for the 4 heads and
//           keeps their sums in registers; with fewer units than threads
//           the threads split the tile's positions into groups whose
//           partial sums are added once, at the end of the split, through
//           the ring's shared memory. A head's sums are rescaled only when
//           its running max moved.
// Each split then writes (m, l, acc[D]) in float32 to a workspace
// [B, Hq, n_split, D + 2], and decode_attention_combine_kernel (grid
// (B, Hq)) forms M = max m_j, L = sum l_j exp(m_j - M) and
// o = sum acc_j exp(m_j - M) / (L == 0 ? 1 : L) in q's type. An empty split
// (m = -1e30, l = 0, acc = 0) adds nothing; a length of 0 gives 0. With one
// split the split kernel normalises and writes o itself, and no combine is
// launched.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;      // cache positions per tile
constexpr int kGroup = 8;      // lanes that score positions together
constexpr int kGroups = kThreads / kGroup;
constexpr int kPos = kTile / kGroups;   // positions a group scores at once
constexpr int kHeads = 4;      // heads per scoring pass and per p @ V unit
constexpr int kMaxAcc = 32;    // float32 accumulators a thread may hold
constexpr int kMinBlocks = 5;  // blocks per SM the registers must allow
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
static_assert(kTile % 32 == 0, "the softmax gives each lane whole positions");
static_assert(kTile % kGroups == 0, "every group scores as many positions");
static_assert(kPos * kHeads % kGroup == 0,
              "a group's dot products split evenly over its lanes");
static_assert(kHeads == 4, "p @ V reads a unit's weights as one float4");

// K/V tiles in flight: the next tile loads while one is computed on (at
// D 128 a stage is 16 KB in bfloat16, 32 KB in float32)
constexpr int kStages = 2;

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

// one 16-byte chunk, widened to float32: 4 floats or 8 bfloat16s
__device__ __forceinline__ void load_chunk(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* f) {
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

// Sum N values v[0..N) over the O * 2 lanes of a group (lanes lg ^ O,
// lg ^ O / 2, ... exchange halves): lane lg ends with the group's sums of
// values lg * (N / (2 O)) + s in v[s], s < N / (2 O), after log2(2 O)
// rounds of N / 2, N / 4, ... shuffles instead of N per round.
template <int N, int O>
__device__ __forceinline__ void group_sum(float* v, int lg) {
  if constexpr (O > 0) {
    const bool upper = lg & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    group_sum<N / 2, O / 2>(v, lg);
  }
}

struct Strides {
  long long q_b, q_h;        // q [B, Hq, D]
  long long k_b, k_s, k_h;   // k cache [B, S, Hkv, D]
  long long v_b, v_s, v_h;   // v cache [B, S, Hkv, D]
};

// heads padded to whole p @ V units
__host__ __device__ inline int padded_heads(int rep) {
  return (rep + kHeads - 1) / kHeads * kHeads;
}

// Tiles per ring stage: K and V, or one tile where K and V are one tensor
// (MLA's latent cache; a float32 K+V ring at D 576 would take 295 KB).
__host__ __device__ inline int tiles_per_stage(bool shared) {
  return shared ? 1 : 2;
}

// Shared memory of one split block serving `heads` query heads: the K/V
// ring in the cache's type (after the last tile, the position groups'
// p @ V partials [kHeads * kV][kThreads] in the same bytes), then float32
// q rows [heads][d], weights [kTile][padded heads], and the running max,
// sum and rescale factor of each head.
template <typename T>
size_t smem_bytes(int heads, int d, bool shared) {
  const size_t ring = sizeof(T) * tiles_per_stage(shared) * kStages *
                      static_cast<size_t>(kTile) * d;
  const size_t red = sizeof(float) * kHeads * (16 / sizeof(T)) * kThreads;
  const size_t floats = static_cast<size_t>(heads) * d +
                        static_cast<size_t>(kTile) * padded_heads(heads) +
                        3 * heads;
  return (ring > red ? ring : red) + sizeof(float) * floats;
}

// Whether one block can serve `heads` query heads at head dim d: its
// (kHeads heads, 16-byte chunk) p @ V units fit the threads' accumulators
// and its shared memory fits a block.
template <typename T>
bool heads_fit(int heads, int d, bool shared) {
  constexpr int kV = 16 / sizeof(T);
  const int units = padded_heads(heads) / kHeads * (d / kV);
  return units <= kThreads * (kMaxAcc / (kHeads * kV)) &&
         smem_bytes<T>(heads, d, shared) <= static_cast<size_t>(kMaxSmem);
}

// Heads per block: all rep where they fit, else the largest multiple of
// kHeads below rep that fits; 0 where none does.
template <typename T>
int plan_heads(int rep, int d, bool shared) {
  if (heads_fit<T>(rep, d, shared)) return rep;
  for (int h = (rep - 1) / kHeads * kHeads; h >= kHeads; h -= kHeads)
    if (heads_fit<T>(h, d, shared)) return h;
  return 0;
}

// A thread's share of a tile copy: the 16-byte chunks i = tid + j kThreads
// (j = 0, 1, ...) of the tile's kTile x nch, at row i / nch and column
// i % nch. The first is found by one division per block; each next one is
// stepped to by (dr, dc) = (kThreads / nch, kThreads % nch) with no division.
struct CopyPlan {
  int r, c, dr, dc;
};

// Copy cache rows [row0, row0 + kTile) of one kv head of K and of V (row
// strides in elements) into shared tiles [kTile][d], or of K alone where
// V is the same tensor; rows at or past `limit` are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_tiles(T* kdst, T* vdst, const T* ksrc,
                                           const T* vsrc, long long k_stride,
                                           long long v_stride, int row0,
                                           int limit, int d, bool shared,
                                           CopyPlan cp) {
  constexpr int kV = 16 / sizeof(T);
  const int nch = d / kV;
  const T* kb = ksrc + row0 * k_stride;
  const T* vb = vsrc + row0 * v_stride;
  int r = cp.r, c = cp.c;
  while (r < kTile) {
    const bool live = row0 + r < limit;
    const int off = r * d + c * kV;
    cp_async16(kdst + off, live ? kb + r * k_stride + c * kV : ksrc, live);
    if (!shared)
      cp_async16(vdst + off, live ? vb + r * v_stride + c * kV : vsrc, live);
    r += cp.dr;
    c += cp.dc;
    if (c >= nch) {
      c -= nch;
      ++r;
    }
  }
}

// acc[j][e] += sum over positions t = pg, pg + n_pg, ... < nt of
// p[t][j] v[t][e] for the unit's first NH heads (weights p at pc, row
// pitch hp; one 16-byte chunk of V at vc, row pitch d)
template <int NH, typename T>
__device__ __forceinline__ void pv_rows(float (*acc)[16 / sizeof(T)],
                                        const float* pc, const T* vc, int hp,
                                        int d, int pg, int n_pg, int nt) {
  constexpr int kV = 16 / sizeof(T);
#pragma unroll 2
  for (int t = pg; t < nt; t += n_pg) {
    const float4 p4 = *reinterpret_cast<const float4*>(pc + t * hp);
    const float p[4] = {p4.x, p4.y, p4.z, p4.w};
    float vf[kV];
    load_chunk(vc + t * d, vf);
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < kV; ++e) acc[j][e] = fmaf(p[j], vf[e], acc[j][e]);
  }
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_attention_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        float* __restrict__ part, int s_len, int split_len,
                        int hq, int hkv, int hpb, int d, float scale,
                        bool shared, Strides st) {
  constexpr int kV = 16 / sizeof(T);        // cache elements per chunk
  constexpr int kQV = 16 / sizeof(TQ);      // q elements per chunk
  constexpr int kUnits = kMaxAcc / (kHeads * kV);  // p @ V units a thread
  constexpr int kDots = kPos * kHeads;      // dot products a lane sums into
  constexpr int kSums = kDots / kGroup;     // ... and holds once reduced
  static_assert(kUnits >= 1, "a thread holds at least one unit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = hq / hkv;
  const int n_hg = (rep + hpb - 1) / hpb;   // head groups per kv head
  const int bg = blockIdx.x / n_hg;
  const int hg = blockIdx.x - bg * n_hg;
  const int b = bg / hkv;
  const int g = bg - b * hkv;
  const int h0 = g * rep + hg * hpb;        // the block's first head
  const int nh = min(hpb, rep - hg * hpb);  // ... and its head count
  const int hp = padded_heads(nh);
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = d / kV;                   // 16-byte chunks per cache row
  const int units = hp / kHeads * nch;      // (kHeads heads, chunk) units
  const int tile_elems = kTile * d;
  const int stage_elems = tiles_per_stage(shared) * tile_elems;
  const size_t ring_bytes = sizeof(T) * kStages * stage_elems;
  const size_t red_bytes = sizeof(float) * kHeads * kV * kThreads;

  T* ring = reinterpret_cast<T*>(smem_raw);    // [kStages][1|2][kTile][d]
  float* red = reinterpret_cast<float*>(smem_raw);  // after the last tile
  float* qs = reinterpret_cast<float*>(
      smem_raw + (ring_bytes > red_bytes ? ring_bytes : red_bytes));
  float* ps = qs + nh * d;                  // [kTile][hp]
  float* run_m = ps + kTile * hp;           // [nh]
  float* run_l = run_m + nh;                // [nh]
  float* alpha = run_l + nh;                // [nh]

  const int len = max(0, min(lengths[b], s_len));
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  // the p @ V units: with fewer units than threads, thread tid owns unit
  // tid % units for position group tid / units; else units tid + i kThreads
  const bool few = units < kThreads;
  const int n_pg = few ? kThreads / units : 1;
  const int pg = few ? tid / units : 0;
  const int u0 = few ? tid - pg * units : tid;

  if (start >= end) {   // nothing live here: an empty partial, or o = 0
    if (n_split == 1) {
      TQ* ob = out + static_cast<long long>(b) * hq * d +
               static_cast<long long>(h0) * d;
      for (int i = tid; i < nh * d; i += kThreads) store(ob + i, 0.0f);
    } else {
      for (int r = 0; r < nh; ++r) {
        float* w = part + ((static_cast<long long>(b) * hq + h0 + r) *
                           n_split + split) * (d + 2);
        for (int i = tid; i < d + 2; i += kThreads)
          w[i] = i == 0 ? kNegInf : 0.0f;
      }
    }
    return;
  }

  const T* kb = k + b * st.k_b + g * st.k_h;
  const T* vb = v + b * st.v_b + g * st.v_h;
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const CopyPlan plan{tid / nch, tid % nch, kThreads / nch, kThreads % nch};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      T* kt = ring + i * stage_elems;
      copy_tiles(kt, kt + tile_elems, kb, vb, st.k_s, st.v_s,
                 start + i * kTile, end, d, shared, plan);
    }
    cp_async_commit();
  }

  for (int i = tid; i < nh * (d / kQV); i += kThreads) {
    const int r = i / (d / kQV);
    const int c = (i - r * (d / kQV)) * kQV;
    float f[kQV];
    load_chunk(q + b * st.q_b + static_cast<long long>(h0 + r) * st.q_h + c,
               f);
#pragma unroll
    for (int e = 0; e < kQV; ++e) qs[r * d + c + e] = f[e];
  }
  // the padded heads' weights stay 0, so their p @ V sums stay 0
  for (int i = tid; i < kTile * hp; i += kThreads) ps[i] = 0.0f;
  for (int r = tid; r < nh; r += kThreads) {
    run_m[r] = kNegInf;
    run_l[r] = 0.0f;
  }
  float acc[kUnits][kHeads][kV];
#pragma unroll
  for (int i = 0; i < kUnits; ++i)
#pragma unroll
    for (int j = 0; j < kHeads; ++j)
#pragma unroll
      for (int e = 0; e < kV; ++e) acc[i][j][e] = 0.0f;

  const int lg = tid & (kGroup - 1);
  const int grp = tid / kGroup;
  for (int it = 0; it < n_tiles; ++it) {
    const int nxt = it + kStages - 1;   // into the stage freed last round
    if (nxt < n_tiles) {
      T* kt = ring + (nxt % kStages) * stage_elems;
      copy_tiles(kt, kt + tile_elems, kb, vb, st.k_s, st.v_s,
                 start + nxt * kTile, end, d, shared, plan);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();       // tile `it` has landed
    __syncthreads();
    const T* ks = ring + (it % kStages) * stage_elems;
    const T* vs = shared ? ks : ks + tile_elems;
    const int t0 = start + it * kTile;
    const int nt = min(kTile, end - t0);   // live rows of this tile

    // scores: group grp dots positions grp + p kGroups (p < kPos) with
    // kHeads heads per pass, each K and q chunk read once per pass; the
    // group's 8 lanes then reduce-scatter the kDots sums
    for (int r0 = 0; r0 < nh; r0 += kHeads) {
      float dot[kDots];                     // [p * kHeads + j]
#pragma unroll
      for (int i = 0; i < kDots; ++i) dot[i] = 0.0f;
      for (int c = lg; c < nch; c += kGroup) {
        float kf[kPos][kV];
#pragma unroll
        for (int p = 0; p < kPos; ++p)
          load_chunk(ks + (grp + p * kGroups) * d + c * kV, kf[p]);
#pragma unroll
        for (int j = 0; j < kHeads; ++j) {
          if (r0 + j < nh) {
            const float* qr = qs + (r0 + j) * d + c * kV;
#pragma unroll
            for (int e = 0; e < kV; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + e);
#pragma unroll
              for (int p = 0; p < kPos; ++p) {
                float& x = dot[p * kHeads + j];
                x = fmaf(qq.x, kf[p][e], x);
                x = fmaf(qq.y, kf[p][e + 1], x);
                x = fmaf(qq.z, kf[p][e + 2], x);
                x = fmaf(qq.w, kf[p][e + 3], x);
              }
            }
          }
        }
      }
      group_sum<kDots, kGroup / 2>(dot, lg);
#pragma unroll
      for (int s = 0; s < kSums; ++s) {
        const int i = lg * kSums + s;
        const int r = r0 + i % kHeads;
        const int t = grp + i / kHeads * kGroups;
        if (r < nh) ps[t * hp + r] = t < nt ? dot[s] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per head, positions lane + 32 i per lane
    for (int r = warp; r < nh; r += kWarps) {
      constexpr int kPer = kTile / 32;
      float x[kPer];
      float m_tile = kNegInf;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        x[i] = ps[(lane + 32 * i) * hp + r];
        m_tile = fmaxf(m_tile, x[i]);
      }
      const float m_prev = run_m[r];
      const float m_cur = fmaxf(m_prev, warp_max(m_tile));
      float p_sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = lane + 32 * i < nt ? expf(x[i] - m_cur) : 0.0f;
        ps[(lane + 32 * i) * hp + r] = p;
        p_sum += p;
      }
      p_sum = warp_sum(p_sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_cur);
        alpha[r] = a;
        run_m[r] = m_cur;
        run_l[r] = run_l[r] * a + p_sum;
      }
    }
    __syncthreads();

    // p @ V: each unit widens a V chunk once for its kHeads heads
    if (pg < n_pg) {
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int u = u0 + i * kThreads;
        if (u < units) {
          const int r0 = u / nch * kHeads;
          const int c = u - u / nch * nch;
#pragma unroll
          for (int j = 0; j < kHeads; ++j) {
            if (r0 + j < nh) {
              const float a = alpha[r0 + j];
              if (a != 1.0f) {
#pragma unroll
                for (int e = 0; e < kV; ++e) acc[i][j][e] *= a;
              }
            }
          }
          const T* vc = vs + c * kV;
          const float* pc = ps + r0;
          switch (min(kHeads, nh - r0)) {    // the unit's live heads
            case 1: pv_rows<1>(acc[i], pc, vc, hp, d, pg, n_pg, nt); break;
            case 2: pv_rows<2>(acc[i], pc, vc, hp, d, pg, n_pg, nt); break;
            case 3: pv_rows<3>(acc[i], pc, vc, hp, d, pg, n_pg, nt); break;
            default: pv_rows<4>(acc[i], pc, vc, hp, d, pg, n_pg, nt);
          }
        }
      }
    }
    __syncthreads();   // this stage and ps are rewritten next round
  }
  cp_async_wait<0>();

  if (n_pg > 1) {   // add the position groups' partials, through the ring
    __syncthreads();
    if (pg < n_pg) {
#pragma unroll
      for (int j = 0; j < kHeads; ++j)
#pragma unroll
        for (int e = 0; e < kV; ++e)
          red[(j * kV + e) * kThreads + tid] = acc[0][j][e];
    }
    __syncthreads();
    if (pg == 0) {
      for (int o = 1; o < n_pg; ++o)
#pragma unroll
        for (int j = 0; j < kHeads; ++j)
#pragma unroll
          for (int e = 0; e < kV; ++e)
            acc[0][j][e] += red[(j * kV + e) * kThreads + o * units + u0];
    }
  }
  if (pg != 0) return;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = u0 + i * kThreads;
    if (u < units) {
      const int r0 = u / nch * kHeads;
      const int c = u - u / nch * nch;
#pragma unroll
      for (int j = 0; j < kHeads; ++j) {
        const int r = r0 + j;
        if (r < nh) {
          const long long h = static_cast<long long>(b) * hq + h0 + r;
          if (n_split == 1) {
            const float l = run_l[r];
            const float den = l == 0.0f ? 1.0f : l;
            TQ* o = out + h * d + c * kV;
#pragma unroll
            for (int e = 0; e < kV; ++e) store(o + e, acc[i][j][e] / den);
          } else {
            float* w = part + (h * n_split + split) * (d + 2);
            if (c == 0) {
              w[0] = run_m[r];
              w[1] = run_l[r];
            }
#pragma unroll
            for (int e = 0; e < kV; ++e) w[2 + c * kV + e] = acc[i][j][e];
          }
        }
      }
    }
  }
}

// Reduce x over the block's kCombineThreads threads with op; every thread
// gets the result (`scratch` holds one value per warp).
template <typename Op>
__device__ __forceinline__ float block_reduce(float x, float* scratch,
                                              Op op) {
  constexpr int kW = kCombineThreads / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();   // scratch may still be read from a previous call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  x = scratch[0];
#pragma unroll
  for (int i = 1; i < kW; ++i) x = op(x, scratch[i]);
  return x;
}

// One block per (b, h): merge the n_split partials of part[b, h] into o.
// The ranges' weights exp(m_j - M) are formed once, in shared memory, and
// every head-dimension element then sums its n_split terms.
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads)
decode_attention_combine_kernel(const float* __restrict__ part,
                                TQ* __restrict__ out, int hq, int n_split,
                                int d) {
  extern __shared__ float wj[];             // [n_split]
  __shared__ float scratch[kCombineThreads / 32];
  const long long bh = static_cast<long long>(blockIdx.x) * hq + blockIdx.y;
  const float* w = part + bh * n_split * (d + 2);
  float m = kNegInf;
  for (int j = threadIdx.x; j < n_split; j += kCombineThreads)
    m = fmaxf(m, w[j * (d + 2)]);
  m = block_reduce(m, scratch, [](float a, float b) { return fmaxf(a, b); });
  float l = 0.0f;
  for (int j = threadIdx.x; j < n_split; j += kCombineThreads) {
    const float x = expf(w[j * (d + 2)] - m);
    wj[j] = x;
    l += w[j * (d + 2) + 1] * x;
  }
  l = block_reduce(l, scratch, [](float a, float b) { return a + b; });
  const float den = l == 0.0f ? 1.0f : l;
  for (int c = threadIdx.x; c < d; c += kCombineThreads) {
    float o = 0.0f;
#pragma unroll 4
    for (int j = 0; j < n_split; ++j) o += w[j * (d + 2) + 2 + c] * wj[j];
    store(out + bh * d + c, o / den);
  }
}

template <typename TQ, typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* part, int n_batch, int s_len, int hq, int hkv,
           int d, int hpb, int smem, int n_split, int split_len, float scale,
           bool shared, const Strides& st, cudaStream_t stream) {
  const int rep = hq / hkv;
  const int heads = plan_heads<T>(rep, d, shared);
  if (heads == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (hpb != heads ||
      static_cast<size_t>(smem) != smem_bytes<T>(hpb, d, shared) ||
      n_split < 1 || split_len < 1 || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(n_batch * hkv * ((rep + hpb - 1) / hpb), n_split);
  decode_attention_kernel<TQ, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), static_cast<float*>(part), s_len, split_len, hq,
      hkv, hpb, d, scale, shared, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  decode_attention_combine_kernel<TQ>
      <<<dim3(n_batch, hq), kCombineThreads, sizeof(float) * n_split,
         stream>>>(static_cast<const float*>(part), static_cast<TQ*>(out),
                   hq, n_split, d);
  return static_cast<int>(cudaGetLastError());
}

// Run f with the (q, cache) element types of (q_dtype, dtype): 0 float32,
// 1 bfloat16; cudaErrorInvalidValue for any other code.
template <typename F>
int with_types(int dtype, int q_dtype, F f) {
  if (dtype == 0 && q_dtype == 0) return f(float(), float());
  if (dtype == 1 && q_dtype == 1)
    return f(__nv_bfloat16(), __nv_bfloat16());
  if (dtype == 1 && q_dtype == 0) return f(float(), __nv_bfloat16());
  if (dtype == 0 && q_dtype == 1) return f(__nv_bfloat16(), float());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype (the caches') and q_dtype: 0 float32, 1 bfloat16. Strides are in
// elements; the head dimension is contiguous. `shared` (nonzero) says that
// k and v are one tensor with one set of strides, whose tiles are then
// loaded once. hpb (heads per block) and smem (its dynamic shared bytes)
// are the caller's plan: a launch whose numbers differ from the kernel's
// own is refused. `part` is a float32 workspace [B, Hq, n_split, D + 2]
// (unused, and may be null, when n_split is 1). Launches the split kernel and, when n_split > 1, the combine
// kernel on `stream`. Returns a cudaError_t code (0 on success).
extern "C" int decode_attention_launch(
    int dtype, int q_dtype, const void* q, const void* k, const void* v,
    const void* lengths, void* out, void* part, int n_batch, int s_len,
    int hq, int hkv, int d, int shared, int hpb, int smem, int n_split,
    int split_len, float scale, long long q_b, long long q_h, long long k_b, long long k_s,
    long long k_h, long long v_b, long long v_s, long long v_h,
    void* stream) {
  if (n_batch <= 0 || hkv <= 0) return 0;
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, q_dtype, [&](auto tq, auto t) {
    using TQ = decltype(tq);
    using T = decltype(t);
    return launch<TQ, T>(q, k, v, lengths, out, part, n_batch, s_len, hq, hkv,
                         d, hpb, smem, n_split, split_len, scale,
                         shared != 0, st, s);
  });
}

// Resident split blocks per SM of the (q_dtype, dtype) kernel at `smem`
// dynamic shared bytes, from the card's occupancy calculator.
extern "C" int decode_attention_blocks_per_sm(int dtype, int q_dtype,
                                              int smem, int* out) {
  return with_types(dtype, q_dtype, [&](auto tq, auto t) {
    using TQ = decltype(tq);
    using T = decltype(t);
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<TQ, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, decode_attention_kernel<TQ, T>, kThreads, smem);
    return static_cast<int>(err);
  });
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
