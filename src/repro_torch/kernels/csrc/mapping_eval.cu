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
// Design: one thread per (b, p) pair loops over t. Predecessor end times are
// read back from the thread's own output row; a position that is not yet
// written (>= t, which includes the sentinel T) or negative reads 0 by a
// branch, so nothing outside the row is ever read. Chip-free times live in
// the thread's `free` output row, zeroed first. Each step does an exact
// fmaxf and ONE add in the reference's order, so the result is bitwise the
// plain torch recurrence (build without --use_fast_math). A chip id outside
// [0, C) or a sched index outside [0, L) touches no memory and poisons the
// step with NaN instead, so a malformed mapping is visible, not wrong.
//
// grid_order 0 (batch_major): thread id = p * B + b; 1 (pop_major):
// thread id = b * P + p. The two orders give identical outputs.
//
// Left for later: at the canonical shape (B = 3, P = 2048) this launches only
// 6,144 threads on 132 SMs, and the T-step chain of dependent global loads
// is latency-bound. Shared-memory rows, a warp per pair and overlapped loads
// come in later revisions.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;

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
// null for the unfused kernel (step t reads tp_row[t]).
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

__global__ void mapping_eval_kernel(const float* __restrict__ t_proc,
                                    const int* __restrict__ chip,
                                    const int* __restrict__ ppos,
                                    float* __restrict__ end,
                                    float* __restrict__ free_out, int n_batch,
                                    int pop, int t_len, int width,
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

__global__ void mapping_eval_fused_kernel(
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

inline unsigned int n_blocks(int n_batch, int pop) {
  const long long n = static_cast<long long>(n_batch) * pop;
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int mapping_eval_launch(const void* t_proc, const void* chip,
                                   const void* ppos, void* end, void* free_out,
                                   int n_batch, int pop, int t_len, int width,
                                   int n_chips, int grid_order,
                                   void* stream) {
  if (n_batch > 0 && pop > 0) {
    mapping_eval_kernel<<<n_blocks(n_batch, pop), kThreads, 0,
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
    mapping_eval_fused_kernel<<<n_blocks(n_batch, pop), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t_proc), static_cast<const int*>(sched_idx),
        static_cast<const int*>(chip), static_cast<const int*>(ppos),
        static_cast<float*>(end), static_cast<float*>(free_out), n_batch, pop,
        t_len, width, n_chips, n_flat, grid_order);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mapping_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
