// Mapping-evaluation timing kernels for Hopper (sm_90a), plain C interface.
//
// Both kernels run the evaluation engine's pass B, the sequential timing
// recurrence over a mapping's scheduled op order, for every (batch b,
// individual p) pair of a GA generation:
//
//     start  = max(free[chip[t]], max_w end[ppos[t, w]])
//     end[t] = free[chip[t]] = start + t_proc[t]
//
// `ppos` pads each step's predecessor list with the sentinel T, which reads
// as 0 (the oracle's max(..., 0)). `mapping_eval_fused` also runs pass A:
// step t's processing time is gathered in-kernel from the un-gathered
// (rows * M)-flat cost row as t_proc[sched_idx[t]].
//
// Every version does an exact fmaxf over exactly the W lanes (max is exact
// and order-free, so any order of the reads gives the same bits) and ONE
// add in the reference's order, so the result is bitwise the plain torch
// recurrence (build without --use_fast_math). A predecessor position
// outside [0, t) reads 0; a chip id outside [0, C) or a sched index outside
// [0, L) touches no memory and poisons the step with NaN instead, so a
// malformed mapping is visible, not wrong.
//
// Two routes, chosen by shape on the host (`row_plan` in mapping_eval.py,
// which reads nothing back from the device):
//
// * shared (`mapping_eval_kernel<kFused>`, one templated body; kFused is
//   pass A). A block serves `ind` individuals and all B batches of each,
//   so an individual's index rows are fetched once per block, as the TPU
//   kernel keeps them resident in SMEM across its batch sweep. One thread
//   runs one (b, p) chain. What stays on chip for the whole chain, in
//   dynamic shared memory, one column per pair (step-major, so thread j
//   always reads bank j): the pair's end row (T floats, a row of zeros for
//   the sentinel, a row of -inf for lanes past W), its C chip-free times
//   and its cost row (L floats from its (B, P, L) or (B, P, T) row, loaded
//   once, and a NaN row for a sched index out of range). Nothing on the
//   chain goes to global memory. Producer warps (PRODUCERS per chain warp)
//   stream the raw `chip`, `ppos` (and `sched_idx`) tiles through a 3-stage
//   ring of 16-byte cp.async copies, each tile two rounds ahead of its use;
//   one tile ahead of the chain they turn a tile into per-step byte offsets
//   (the W predecessor rows, the chip's free slot, the cost row); behind
//   the chain they write the finished end rows to global memory, 16 bytes a
//   store. One block barrier per tile. A chain step reads its offsets a
//   step ahead, so it waits only on end[ppos] -> fmaxf tree -> fmaxf(free)
//   -> add -> store.
//   What bounds it on an H100: at small P, where every pair is in flight
//   at once, one chain's latency (~120-130 cycles a step: the step's
//   ~60 instructions issue from one warp with little to overlap); at large
//   P, the producers (the plan's blocks fill the card's shared memory, and
//   P 4096 at T = L = 320 takes two waves). The bytes are far below both.
// * global (`mapping_eval_global_kernel`, `mapping_eval_fused_global_
//   kernel`): the first design, kept for chains whose rows do not fit in a
//   block's shared memory. One thread per pair loops over t and reads its
//   predecessors back from its own global output row.
//
// grid_order 0 (batch_major) and 1 (pop_major) give identical outputs. On
// the shared route they set which pairs share a warp: batch_major puts an
// individual's B pairs side by side (their index reads broadcast), pop_major
// puts one batch's individuals side by side. On the global route: thread id
// = p * B + b, or b * P + p.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// ------------------------------------------------------------------------
// shared-row route
// ------------------------------------------------------------------------

constexpr int kLanes = 8;         // predecessor lanes read as two int4s
constexpr int kMaxThreads = 512;  // chain warps + producer warps
constexpr int kMaxDevices = 64;
constexpr long long kRawStages = 3;  // raw index tiles in flight

// Shapes and the host plan, passed by value. `n_flat` is the cost row's
// length: T unfused, L fused.
struct Geometry {
  int n_batch, pop, t_len, width, n_chips, n_flat;
  int ind;         // individuals per block
  int tile;        // steps per staged tile: 4, 8, 16 or 32
  int grid_order;  // 0 batch_major, 1 pop_major
  int producers;   // producer warps
  int vec;         // index and end rows allow 16-byte accesses
};

// Offsets into dynamic shared memory in 4-byte words; every region that a
// 16-byte copy or load lands in starts on a multiple of 4 words.
// `smem_bytes` in mapping_eval.py computes the same sizes.
struct Layout {
  int pairs;        // ind * B chains
  int stride;       // words between two steps of the end and cost rows
  int chip_stride;  // words per individual in a chip / sched stage
  int ppos_stride;  // words per individual in a ppos stage
  int out_width;    // words per step of placed offsets
  int offs_stride;  // words per individual in an offsets stage
  long long rows, free, cost, chip, ppos, sched, offs, table, words;
};

__host__ __device__ inline long long up4(long long n) {
  return (n + 3) / 4 * 4;
}

__host__ __device__ inline Layout layout_of(const Geometry& g, bool fused) {
  Layout l;
  l.pairs = g.ind * g.n_batch;
  // one individual's pairs share every index, so they never conflict;
  // more than one take a multiple of 32 columns
  l.stride = g.ind == 1 ? l.pairs : (l.pairs + 31) / 32 * 32;
  l.chip_stride = g.tile + 4;
  l.ppos_stride = g.tile * g.width + 4;
  l.out_width = static_cast<int>(up4((g.width > kLanes ? g.width : kLanes)
                                     + 2));
  l.offs_stride = g.tile * l.out_width + 4;
  l.rows = 0;
  l.free = up4(static_cast<long long>(g.t_len + 2) * l.stride);
  l.cost = l.free + up4(static_cast<long long>(g.n_chips) * l.stride);
  l.chip = l.cost + up4(static_cast<long long>(g.n_flat + 1) * l.stride);
  l.ppos = l.chip + kRawStages * g.ind * l.chip_stride;
  l.sched = l.ppos + kRawStages * g.ind * l.ppos_stride;
  l.offs = l.sched + (fused ? kRawStages * g.ind * l.chip_stride : 0);
  l.table = l.offs + 2LL * g.ind * l.offs_stride;
  l.words = l.table + up4(2LL * l.pairs);
  return l;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The chain's shared-memory accesses, by 32-bit shared address: one add
// forms each address, and their order is the program's.
__device__ __forceinline__ float lds_f32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ int lds_s32(unsigned a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ int2 lds_v2(unsigned a) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ int4 lds_v4(unsigned a) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts_f32(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// The producer threads (`lane` of `lanes`) copy `n` words of each of
// `n_ind` individuals' rows: individual i's from src + i * src_stride to
// dst + i * dst_stride.
__device__ __forceinline__ void stage_rows(int* dst, int dst_stride,
                                           const int* src,
                                           long long src_stride, int n,
                                           int n_ind, int lane, int lanes,
                                           bool vec) {
  const int w = vec ? 4 : 1;
  const int per = n / w;  // copies per individual
  int i = 0, c = lane;
  while (i < n_ind && c >= per) { c -= per; ++i; }
#pragma unroll 1
  while (i < n_ind) {
    int* d = dst + i * dst_stride + c * w;
    const int* s = src + i * src_stride + c * w;
    if (vec) cp_async16(d, s);
    else cp_async4(d, s);
    c += lanes;
    while (i < n_ind && c >= per) { c -= per; ++i; }
  }
}

// The finished end rows of steps [ta, tb), from shared to global memory:
// 16 bytes a store where the rows allow it. Pairs run fastest, so the
// shared reads never conflict.
__device__ __forceinline__ void write_rows(float* __restrict__ end,
                                           const float* rows,
                                           const int* pair_row,
                                           const Geometry& g,
                                           const Layout& l, int ta, int tb,
                                           int first, int step) {
#pragma unroll 1
  for (int j = first; j < l.pairs; j += step) {
#pragma unroll 1
    for (int t = ta; t < tb; t += 4) {
      const int row = pair_row[j];
      if (row < 0) continue;
      const float* s = rows + static_cast<long long>(t) * l.stride + j;
      float* d = end + static_cast<long long>(row) * g.t_len + t;
      if (g.vec && t + 4 <= tb) {
        *reinterpret_cast<float4*>(d) = make_float4(
            s[0], s[l.stride], s[2 * l.stride], s[3 * l.stride]);
      } else {
#pragma unroll 1
        for (int k = 0; t + k < tb && k < 4; ++k) d[k] = s[k * l.stride];
      }
    }
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kMaxThreads)
    mapping_eval_kernel(const float* __restrict__ t_proc,
                        const int* __restrict__ sched_idx,
                        const int* __restrict__ chip,
                        const int* __restrict__ ppos,
                        float* __restrict__ end, float* __restrict__ free_out,
                        Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout_of(g, kFused);
  float* rows = smem + l.rows;  // [T + 2][stride]: row T zeros, T+1 -inf
  float* free_s = smem + l.free;                      // [C][stride]
  float* cost_s = smem + l.cost;  // [L + 1][stride]: row L NaN
  int* chip_s = reinterpret_cast<int*>(smem + l.chip);    // [3][ind][...]
  int* ppos_s = reinterpret_cast<int*>(smem + l.ppos);    // [3][ind][...]
  int* sched_s = reinterpret_cast<int*>(smem + l.sched);  // [3][ind][...]
  int* offs_s = reinterpret_cast<int*>(smem + l.offs);    // [2][ind][...]
  int* pair_row = reinterpret_cast<int*>(smem + l.table);  // [pairs]
  int* pair_ind = pair_row + l.pairs;                      // [pairs]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int chains = (l.pairs + 31) / 32 * 32;  // threads [0, chains) run
                                               // chains, the rest produce
  const int p0 = blockIdx.x * g.ind;
  const int n_ind = min(g.ind, g.pop - p0);
  const int t_len = g.t_len, width = g.width, n_chips = g.n_chips;
  const int n_tiles = (t_len + g.tile - 1) / g.tile;
  const int chip_stage = g.ind * l.chip_stride;
  const int ppos_stage = g.ind * l.ppos_stride;
  const int offs_stage = g.ind * l.offs_stride;
  const int stride4 = 4 * l.stride;
  const int zero4 = t_len * stride4, ninf4 = (t_len + 1) * stride4;

  for (int k = tid; k < l.stride; k += nthr) {
    rows[t_len * l.stride + k] = 0.0f;
    rows[(t_len + 1) * l.stride + k] = -INFINITY;
  }
  for (int k = tid; k < n_chips * l.stride; k += nthr) free_s[k] = 0.0f;
  for (int k = tid; k < l.stride; k += nthr)
    cost_s[g.n_flat * l.stride + k] = nanf("");
  for (int j = tid; j < l.pairs; j += nthr) {
    int i, b;
    if (g.grid_order == 0) {
      i = j / g.n_batch;
      b = j - i * g.n_batch;
    } else {
      b = j / g.ind;
      i = j - b * g.ind;
    }
    pair_ind[j] = i;
    pair_row[j] = i < n_ind ? b * g.pop + p0 + i : -1;
  }
  __syncthreads();

  // The producers' jobs: the cost rows once; raw tiles (chip, ppos,
  // sched), placed offsets and the finished rows tile by tile.
  const int lane = tid - chains, lanes = nthr - chains;
  auto stage_raw = [&](int k) {
    const int t0 = k * g.tile, ts = min(g.tile, t_len - t0);
    const int st = k % kRawStages;
    const long long base = static_cast<long long>(p0) * t_len + t0;
#pragma unroll 1
    for (int a = 0; a < (kFused ? 3 : 2); ++a) {  // chip, ppos, sched
      const int w = a == 1 ? width : 1;
      stage_rows((a == 0 ? chip_s : a == 1 ? ppos_s : sched_s) +
                     st * (a == 1 ? ppos_stage : chip_stage),
                 a == 1 ? l.ppos_stride : l.chip_stride,
                 (a == 0 ? chip : a == 1 ? ppos : sched_idx) + base * w,
                 static_cast<long long>(t_len) * w, ts * w, n_ind, lane,
                 lanes, g.vec);
    }
  };
  // Raw tile k (stage st) -> per step: [0, 8) and [10, W + 2) the lanes'
  // byte offsets into a pair's end column (the row of a position in
  // [0, t), the zero row for any other, the -inf row for a lane past W);
  // [8] the chip's byte offset into its free column, -1 for a chip out of
  // range; [9] the cost's byte offset into its cost column (row
  // sched_idx[t], or t unfused; the NaN row for an index out of range).
  auto place = [&](int k) {
    const int t0 = k * g.tile, ts = min(g.tile, t_len - t0);
    const int st = k % kRawStages, os = k & 1;
    const int last = width - 1;
    int i = 0, tt = lane;
    while (i < n_ind && tt >= ts) { tt -= ts; ++i; }
#pragma unroll 1
    while (i < n_ind) {
      const int t = t0 + tt;
      const int* r = ppos_s + st * ppos_stage + i * l.ppos_stride +
                     tt * width;
      int* o = offs_s + os * offs_stage + i * l.offs_stride +
               tt * l.out_width;
      int x[kLanes];
#pragma unroll
      for (int w = 0; w < kLanes; ++w) x[w] = r[min(w, last)];
      const int c = chip_s[st * chip_stage + i * l.chip_stride + tt];
      const int li =
          kFused ? sched_s[st * chip_stage + i * l.chip_stride + tt] : t;
      auto offset = [&](int w, int v) {
        return w > last ? ninf4
               : static_cast<unsigned>(v) < static_cast<unsigned>(t)
                   ? v * stride4
                   : zero4;
      };
      *reinterpret_cast<int4*>(o) =
          make_int4(offset(0, x[0]), offset(1, x[1]), offset(2, x[2]),
                    offset(3, x[3]));
      *reinterpret_cast<int4*>(o + 4) =
          make_int4(offset(4, x[4]), offset(5, x[5]), offset(6, x[6]),
                    offset(7, x[7]));
      *reinterpret_cast<int2*>(o + kLanes) = make_int2(
          static_cast<unsigned>(c) < static_cast<unsigned>(n_chips)
              ? c * stride4
              : -1,
          (static_cast<unsigned>(li) < static_cast<unsigned>(g.n_flat)
               ? li
               : g.n_flat) * stride4);
#pragma unroll 1
      for (int w = kLanes; w < width; ++w) o[w + 2] = offset(w, r[w]);
      tt += lanes;
      while (i < n_ind && tt >= ts) { tt -= ts; ++i; }
    }
  };
  // every pair's cost row (L floats, from its (B, P, L) or (B, P, T)
  // row) into its column of cost_s, 16 bytes a load where the rows allow
  // it; pairs run fastest, so the stores never conflict
  auto load_costs = [&]() {
    const bool v4 = g.n_flat % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(t_proc) & 15) == 0;
    const int per = v4 ? 4 : 1, quads = (g.n_flat + per - 1) / per;
    const int total = quads * l.pairs;
    constexpr int kBatch = 8;  // loads in flight per thread
#pragma unroll 1
    for (int q0 = lane; q0 < total; q0 += kBatch * lanes) {
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * lanes;
        const int quad = q / l.pairs, jj = q - quad * l.pairs;
        const int row = q < total ? pair_row[jj] : -1;
        const float* src =
            t_proc + static_cast<long long>(row) * g.n_flat + quad * per;
        if (row >= 0 && v4)
          x[u] = __ldg(reinterpret_cast<const float4*>(src));
        else if (row >= 0)
          x[u].x = __ldg(src);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * lanes;
        const int quad = q / l.pairs, jj = q - quad * l.pairs;
        if (q >= total || pair_row[jj] < 0) continue;
        float* dst = cost_s + quad * per * l.stride + jj;
        dst[0] = x[u].x;
        if (v4) {
          dst[l.stride] = x[u].y;
          dst[2 * l.stride] = x[u].z;
          dst[3 * l.stride] = x[u].w;
        }
      }
    }
  };

  const int j = tid;
  const bool chain = j < l.pairs && pair_row[j] >= 0;
  const int i = chain ? pair_ind[j] : 0;
  const unsigned ecol = smem_u32(rows + j), fcol = smem_u32(free_s + j);
  const unsigned ccol = smem_u32(cost_s + j), ow4 = 4 * l.out_width;

  // Round k: the chains run tile k while the producers place tile k + 1
  // (its raw tile landed in round k - 1), stage raw tile k + 3 and write
  // tile k - 1's rows, then wait for raw tile k + 2. Rounds -3, -2
  // (producers alone; the cost rows first) and -1 are the prologue; in
  // round n_tiles the producers write the last tile.
  const bool producer = tid >= chains;
#pragma unroll 1
  for (int k = producer ? -3 : -1; k < n_tiles + producer; ++k) {
    const int t0 = k * g.tile, ts = min(g.tile, t_len - t0), st = k & 1;
    if (producer) {
      if (k == -3) load_costs();
      if (k + 1 >= 0 && k + 1 < n_tiles) place(k + 1);
      if (k + 3 < n_tiles) stage_raw(k + 3);
      cp_async_commit();
      if (k > 0)
        write_rows(end, rows, pair_row, g, l, t0 - g.tile, min(t0, t_len),
                   lane, lanes);
      cp_async_wait_prior();
    } else if (chain && k >= 0) {
      // a step's placed offsets are read a step ahead, so the chain waits
      // only on end[ppos] -> fmaxf -> add -> store
      const unsigned obase =
          smem_u32(offs_s + st * offs_stage + i * l.offs_stride);
      unsigned dst = ecol + t0 * stride4;
      int4 a = lds_v4(obase), b = lds_v4(obase + 16);
      int2 fc = lds_v2(obase + 4 * kLanes);
#pragma unroll 2
      for (int tt = 0; tt < ts; ++tt) {
        const float e0 = lds_f32(ecol + a.x), e1 = lds_f32(ecol + a.y);
        const float e2 = lds_f32(ecol + a.z), e3 = lds_f32(ecol + a.w);
        const float e4 = lds_f32(ecol + b.x), e5 = lds_f32(ecol + b.y);
        const float e6 = lds_f32(ecol + b.z), e7 = lds_f32(ecol + b.w);
        const float f = lds_f32(fcol + max(fc.x, 0));
        const float tp = lds_f32(ccol + fc.y);
        const unsigned next = obase + min(tt + 1, ts - 1) * ow4;
        const int4 na = lds_v4(next), nb = lds_v4(next + 16);
        const int2 nfc = lds_v2(next + 4 * kLanes);
        float pred = fmaxf(fmaxf(fmaxf(e0, e1), fmaxf(e2, e3)),
                           fmaxf(fmaxf(e4, e5), fmaxf(e6, e7)));
#pragma unroll 1
        for (int w = kLanes; w < width; ++w)  // lanes past the eighth
          pred = fmaxf(pred, lds_f32(ecol + lds_s32(obase + tt * ow4 +
                                                    4 * (w + 2))));
        float fin = nanf("");
        if (fc.x >= 0) {
          fin = fmaxf(f, pred) + tp;
          sts_f32(fcol + fc.x, fin);
        }
        sts_f32(dst, fin);
        dst += stride4;
        a = na;
        b = nb;
        fc = nfc;
      }
    }
    if (k < -1)
      asm volatile("bar.sync 1, %0;\n" ::"r"(lanes) : "memory");
    else if (k < n_tiles)
      __syncthreads();
  }
  for (int q = tid; q < l.pairs * n_chips; q += nthr) {
    const int jj = q / n_chips, c = q - jj * n_chips;
    const int row = pair_row[jj];
    if (row >= 0)
      free_out[static_cast<long long>(row) * n_chips + c] =
          free_s[c * l.stride + jj];
  }
}

// Raise the kernel's dynamic shared memory limit to the card's once per
// instantiation and device.
template <bool kFused>
cudaError_t allow_smem(int device) {
  static std::atomic<int> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load()) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mapping_eval_kernel<kFused>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess) done[device].store(1);
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kFused>
int launch_rows(const void* t_proc, const void* sched_idx, const void* chip,
                const void* ppos, void* end, void* free_out, Geometry g,
                long long smem_bytes, cudaStream_t stream) {
  const Layout l = layout_of(g, kFused);
  const int threads = (l.pairs + 31) / 32 * 32 + 32 * g.producers;
  if (g.ind < 1 || g.producers < 1 || (g.tile != 4 && g.tile != 8 && g.tile != 16 &&
                    g.tile != 32) || g.width < 1 || g.n_chips < 1 ||
      threads > kMaxThreads || 4 * l.words != smem_bytes ||
      static_cast<long long>(g.n_batch) * g.pop > INT32_MAX ||
      4LL * (g.t_len + 2) * l.stride > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = allow_smem<kFused>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  g.vec = g.t_len % 4 == 0 && aligned16(chip) && aligned16(ppos) &&
          aligned16(end) && (!kFused || aligned16(sched_idx));
  const unsigned blocks = static_cast<unsigned>((g.pop + g.ind - 1) / g.ind);
  mapping_eval_kernel<kFused><<<blocks, threads, smem_bytes, stream>>>(
      static_cast<const float*>(t_proc), static_cast<const int*>(sched_idx),
      static_cast<const int*>(chip), static_cast<const int*>(ppos),
      static_cast<float*>(end), static_cast<float*>(free_out), g);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// global-row route (long chains)
// ------------------------------------------------------------------------

constexpr int kGlobalThreads = 64;

__device__ __forceinline__ void pair_of(long long tid, int n_batch, int pop,
                                        int grid_order, int* b, int* p) {
  if (grid_order == 0) {
    *b = static_cast<int>(tid % n_batch);
    *p = static_cast<int>(tid / n_batch);
  } else {
    *p = static_cast<int>(tid % pop);
    *b = static_cast<int>(tid / pop);
  }
}

// One (b, p) recurrence. `tp_row` is the pair's cost row; `sched_row` is
// null for the unfused kernel (step t reads tp_row[t]). Predecessor end
// times are read back from the thread's own output row, and chip-free
// times live in its `free` output row, zeroed first.
__device__ __forceinline__ void recurrence(
    const float* __restrict__ tp_row, int n_flat,
    const int* __restrict__ sched_row, const int* __restrict__ chip_row,
    const int* __restrict__ ppos_row, float* __restrict__ end_row,
    float* __restrict__ free_row, int t_len, int width, int n_chips) {
  for (int c = 0; c < n_chips; ++c) free_row[c] = 0.0f;
  for (int t = 0; t < t_len; ++t) {
    float pred = -INFINITY;  // width >= 1: max over exactly the W lanes
    const int* pp = ppos_row + static_cast<long long>(t) * width;
    for (int w = 0; w < width; ++w) {
      const int idx = pp[w];
      const float e = (idx >= 0 && idx < t) ? end_row[idx] : 0.0f;
      pred = fmaxf(pred, e);
    }
    float tp;
    if (sched_row == nullptr) {
      tp = tp_row[t];
    } else {
      const int li = sched_row[t];
      tp = (li >= 0 && li < n_flat) ? tp_row[li] : nanf("");
    }
    const int c = chip_row[t];
    float fin;
    if (c >= 0 && c < n_chips) {
      fin = fmaxf(free_row[c], pred) + tp;
      free_row[c] = fin;
    } else {
      fin = nanf("");
    }
    end_row[t] = fin;
  }
}

__global__ void mapping_eval_global_kernel(
    const float* __restrict__ t_proc, const int* __restrict__ chip,
    const int* __restrict__ ppos, float* __restrict__ end,
    float* __restrict__ free_out, int n_batch, int pop, int t_len, int width,
    int n_chips, int grid_order) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(n_batch) * pop) return;
  int b, p;
  pair_of(tid, n_batch, pop, grid_order, &b, &p);
  const long long row = static_cast<long long>(b) * pop + p;
  recurrence(t_proc + row * t_len, t_len, nullptr,
             chip + static_cast<long long>(p) * t_len,
             ppos + static_cast<long long>(p) * t_len * width,
             end + row * t_len, free_out + row * n_chips, t_len, width,
             n_chips);
}

__global__ void mapping_eval_fused_global_kernel(
    const float* __restrict__ t_proc, const int* __restrict__ sched_idx,
    const int* __restrict__ chip, const int* __restrict__ ppos,
    float* __restrict__ end, float* __restrict__ free_out, int n_batch,
    int pop, int t_len, int width, int n_chips, int n_flat, int grid_order) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(n_batch) * pop) return;
  int b, p;
  pair_of(tid, n_batch, pop, grid_order, &b, &p);
  const long long row = static_cast<long long>(b) * pop + p;
  recurrence(t_proc + row * n_flat, n_flat,
             sched_idx + static_cast<long long>(p) * t_len,
             chip + static_cast<long long>(p) * t_len,
             ppos + static_cast<long long>(p) * t_len * width,
             end + row * t_len, free_out + row * n_chips, t_len, width,
             n_chips);
}

inline unsigned int global_blocks(int n_batch, int pop) {
  const long long n = static_cast<long long>(n_batch) * pop;
  return static_cast<unsigned int>((n + kGlobalThreads - 1) / kGlobalThreads);
}

}  // namespace

// The shared route. `fused` selects pass A; `ind`, `tile` and the
// producer warps are the host plan's, and `smem_bytes` its dynamic shared
// memory, which must equal the layout's. Returns a cudaError_t code (0 on success).
extern "C" int mapping_eval_rows_launch(
    int fused, const void* t_proc, const void* sched_idx, const void* chip,
    const void* ppos, void* end, void* free_out, int n_batch, int pop,
    int t_len, int width, int n_chips, int n_flat, int ind, int tile,
    int producers, int grid_order, long long smem_bytes, void* stream) {
  if (n_batch <= 0 || pop <= 0) return 0;
  const Geometry g{n_batch, pop, t_len, width, n_chips, n_flat,
                   ind, tile, grid_order, producers, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fused ? launch_rows<true>(t_proc, sched_idx, chip, ppos, end,
                                   free_out, g, smem_bytes, s)
               : launch_rows<false>(t_proc, sched_idx, chip, ppos, end,
                                    free_out, g, smem_bytes, s);
}

extern "C" int mapping_eval_launch(const void* t_proc, const void* chip,
                                   const void* ppos, void* end, void* free_out,
                                   int n_batch, int pop, int t_len, int width,
                                   int n_chips, int grid_order,
                                   void* stream) {
  if (n_batch > 0 && pop > 0) {
    mapping_eval_global_kernel<<<global_blocks(n_batch, pop),
                                 kGlobalThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t_proc), static_cast<const int*>(chip),
        static_cast<const int*>(ppos), static_cast<float*>(end),
        static_cast<float*>(free_out), n_batch, pop, t_len, width, n_chips,
        grid_order);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mapping_eval_fused_launch(const void* t_proc,
                                         const void* sched_idx,
                                         const void* chip, const void* ppos,
                                         void* end, void* free_out,
                                         int n_batch, int pop, int t_len,
                                         int width, int n_chips, int n_flat,
                                         int grid_order, void* stream) {
  if (n_batch > 0 && pop > 0) {
    mapping_eval_fused_global_kernel<<<global_blocks(n_batch, pop),
                                       kGlobalThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t_proc), static_cast<const int*>(sched_idx),
        static_cast<const int*>(chip), static_cast<const int*>(ppos),
        static_cast<float*>(end), static_cast<float*>(free_out), n_batch, pop,
        t_len, width, n_chips, n_flat, grid_order);
  }
  return static_cast<int>(cudaGetLastError());
}

// The card's SM count, shared memory a block may opt in to, and shared
// memory per SM: out[0..2].
extern "C" int mapping_eval_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMultiProcessorCount,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrMaxSharedMemoryPerMultiprocessor};
  for (int k = 0; k < 3; ++k) {
    const cudaError_t err = cudaDeviceGetAttribute(out + k, attrs[k], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Resident blocks per SM of the shared-route kernel at this block size and
// dynamic shared memory, from the occupancy calculator, into *out.
extern "C" int mapping_eval_blocks_per_sm(int fused, int threads,
                                          long long smem_bytes, int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fused ? allow_smem<true>(device) : allow_smem<false>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(smem_bytes);
  err = fused ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    out, mapping_eval_kernel<true>, threads, bytes)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    out, mapping_eval_kernel<false>, threads, bytes);
  return static_cast<int>(err);
}

extern "C" const char* mapping_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
