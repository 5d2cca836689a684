// Scatter-add probe for Hopper (sm_90a), the scatter kernel of the port's
// gather/scatter probes (soc_tpu_torch/probes/).
//
// Replaces the Pallas scatter kernels of the probe scripts:
//   S1 vector scatter-add, scripts/probe_gather.py (pallas_call at :207):
//     out = 0; for i < reps: out[(ix[n] + i) mod M] += v[n]
//   S2 lane-local scatter-add, scripts/probe_gather2.py (:230):
//     a = 0; j = ix; for i < reps: j = lcg(j, i, M); a[s, j[s, l]] += v[s, l]
//     over rows s of M lanes' slots (M = 128)
// with the index rules of csrc/probe_index.cuh (ADD, LCG_BEFORE), shared
// with the gather kernel; every rule runs in every layout (FLAT, ROW).
//
// What bounds it: random adds into a table that stays in L2 (S1: 1 MB) or
// in shared memory (S2: a row of 128 slots), and, at the probes' sizes,
// the launches. The first design gave each lane a thread that issued
// `reps` global atomics (524,288 for S1, about 62G a second on an H100),
// divided on every add to reduce its index, and had the wrapper zero `out`
// with a separate fill; S2 ran 1,024 blocks of one row each. This one:
//   - FLAT with ADD (S1): a lane's reps adds land on consecutive cells, so
//     out[c] = sum_{i < reps} H[(c - i) mod M] with H[c] = sum of v[n] over
//     the lanes with ix[n] mod M = c, a cyclic convolution. The kernel
//     zeroes H (a memset of the wrapper's scratch), deposits H with one
//     global atomic a lane (131,072 for S1; H, 1 MB, stays in L2), then a
//     stencil pass writes every cell of `out` from H, so `out` needs no
//     fill. H held instead in the shared memory of groups of 8 blocks, as
//     the one-hot kernel holds its table (csrc/probe_onehot.cu), each block
//     owning 1/8 of the cells and the stencil's halo, ran 0.0118 ms against
//     this form's 0.0056 on an H100 (PERF.md), and was dropped;
//   - FLAT with LCG_BEFORE: no convolution form; one global atomic a step
//     into `out` (a memset first);
//   - ROW (S2): several rows a block, a thread a lane (S2: 8 rows of 128
//     lanes in blocks of 1024 threads, 128 blocks, not 1,024 of 128), each
//     row's M slots in its slice of shared memory, shared-memory atomics,
//     then the slices written out, float4 where M is a multiple of 4. A
//     warp a row (its lanes strided over 32 threads) ran 0.0064 ms against
//     the first design's 0.0045 (PERF.md): a float atomic add to shared
//     memory is a compare-and-swap loop on this card (LDS, ATOMS.CAST.SPIN
//     in the SASS), so a thread's adds must not queue behind each other;
//   - no division in any loop: ADD steps its index with a compare and
//     reset; the LCG's floored modulus is a mask for a power of two, else
//     a multiply-high (probe::FloorMod).
// How the sums associate: each cell's deposits are added in the order the
// atomics land, which changes from run to run; the stencil then adds a
// cell's reps terms in ascending cell order (the last step's first). So
// the check against the plain version (index_add_ step by step) is 1e-5
// of the maximum, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_index.cuh"

namespace {

using probe::ADD;
using probe::FloorMod;
using probe::LCG_BEFORE;
using probe::Walk;
using probe::set_smem;

enum { FLAT = 0, ROW = 1 };

constexpr int THREADS = 256;         // FLAT deposits and the stencil
constexpr int ROW_THREADS = 1024;    // ROW: threads a block (rows x lanes)

// out[c] for c in [c0, c0 + 4) and c < m: sum_{i < reps} src[(c - i) mod
// m], reading src at p = (c0 - reps + 1) mod m onwards (any reps, wrapping
// as often as it must); o[k] gets the terms in ascending p.
__device__ __forceinline__ void stencil4(const float* src, int64_t c0,
                                         const FloorMod& fm, int reps,
                                         float o[4]) {
  int p = fm((int)(c0 - (reps - 1)));
  for (int q = 0; q < reps + 3; ++q) {
    const float x = src[p];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (q >= k && q < k + reps) o[k] += x;
    p = p + 1 == fm.d ? 0 : p + 1;
  }
}

// FLAT with ADD, step 1: H[ix[n] mod M] += v[n], one atomic a lane.
__global__ void deposit_add(const int* __restrict__ ix,
                            const float* __restrict__ v,
                            float* __restrict__ h, int n, FloorMod fm) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) atomicAdd(h + fm(ix[lane]), v[lane]);
}

// FLAT with ADD, step 2: every cell of out from H, 4 consecutive cells a
// thread (one float4 store where M is a multiple of 4).
__global__ void stencil_add(const float* __restrict__ h,
                            float* __restrict__ out, FloorMod fm, int reps) {
  const int64_t c0 = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (c0 >= fm.d) return;
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  stencil4(h, c0, fm, reps, o);
  if ((fm.d & 3) == 0) {
    *reinterpret_cast<float4*>(out + c0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    for (int k = 0; k < 4 && c0 + k < fm.d; ++k) out[c0 + k] = o[k];
  }
}

// FLAT with LCG_BEFORE: one atomic a step into out (zeroed first).
__global__ void flat_lcg(const int* __restrict__ ix,
                         const float* __restrict__ v, float* __restrict__ out,
                         int n, FloorMod fm, int reps) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Walk<LCG_BEFORE> w(ix[lane], fm);
  const float val = v[lane];
  for (int i = 0; i < reps; ++i) atomicAdd(out + w.next(i), val);
}

// ROW: block b holds rows [b rpb, (b + 1) rpb), tpr threads a row (the
// row's lanes strided over them), each row's M slots (padded to mp, a
// multiple of 4) in its slice of shared memory.
template <int RULE>
__global__ void __launch_bounds__(ROW_THREADS)
row_add(const int* __restrict__ ix, const float* __restrict__ v,
        float* __restrict__ out, int rows, int row_lanes, FloorMod fm,
        int reps, int mp, int tpr) {
  extern __shared__ float4 s_rows4[];
  const int rpb = blockDim.x / tpr;
  const int sub = threadIdx.x / tpr, t = threadIdx.x - sub * tpr;
  const int row = blockIdx.x * rpb + sub;
  float* s = reinterpret_cast<float*>(s_rows4) + (size_t)sub * mp;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = threadIdx.x; k < rpb * mp / 4; k += blockDim.x)
    s_rows4[k] = zero;
  __syncthreads();
  const int64_t base = (int64_t)row * row_lanes;
  if (row < rows) {
    for (int l = t; l < row_lanes; l += tpr) {
      Walk<RULE> w(ix[base + l], fm);
      const float val = v[base + l];
      for (int i = 0; i < reps; ++i) atomicAdd(s + w.next(i), val);
    }
  }
  __syncthreads();
  if (row >= rows) return;
  float* dst = out + (int64_t)row * fm.d;
  if ((fm.d & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int k = t; k < fm.d / 4; k += tpr) dst4[k] = s4[k];
  } else {
    for (int k = t; k < fm.d; k += tpr) dst[k] = s[k];
  }
}

int blocks(int64_t work, int per_block) {
  return (int)((work + per_block - 1) / per_block);
}

int launch_flat_add(const int* ix, const float* v, float* out, float* h,
                    int n, FloorMod fm, int reps, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(h, 0, sizeof(float) * (size_t)fm.d, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) deposit_add<<<blocks(n, THREADS), THREADS, 0, s>>>(ix, v, h, n,
                                                               fm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stencil_add<<<blocks(fm.d, 4 * THREADS), THREADS, 0, s>>>(h, out, fm,
                                                           reps);
  return (int)cudaGetLastError();
}

// ROW: tpr threads a row (its lanes rounded up to a warp, at most
// ROW_THREADS), as many rows a block as ROW_THREADS threads and the shared
// memory take, one block per group of rows.
template <int RULE>
int launch_row(const int* ix, const float* v, float* out, int rows,
               int row_lanes, FloorMod fm, int reps, cudaStream_t s) {
  if (rows == 0) return (int)cudaSuccess;
  const int cap = probe::max_smem();
  const int mp = (fm.d + 3) & ~3;
  const size_t per_row = sizeof(float) * (size_t)mp;
  if (cap < 0 || per_row > (size_t)cap) return (int)cudaErrorInvalidValue;
  const int tpr = row_lanes <= 32 ? 32
                  : row_lanes >= ROW_THREADS ? ROW_THREADS
                                             : (row_lanes + 31) & ~31;
  int rpb = ROW_THREADS / tpr;
  if ((size_t)rpb * per_row > (size_t)cap) rpb = (int)((size_t)cap / per_row);
  if (rpb > rows) rpb = rows;
  const size_t smem = per_row * rpb;
  auto kern = row_add<RULE>;
  const int e = set_smem(kern, smem);
  if (e != 0) return e;
  kern<<<blocks(rows, rpb), rpb * tpr, smem, s>>>(ix, v, out, rows,
                                                  row_lanes, fm, reps, mp,
                                                  tpr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scatter-add on `stream`; returns the cudaError_t of the
// launch. FLAT: ix, v [n] -> out [mod]; ROW: ix, v [rows, row_lanes] ->
// out [rows, mod]. The kernel writes every entry of out (the caller need
// not zero it). scratch: H [mod] for FLAT with ADD, else unused.
int probe_scatter(const int* ix, const float* v, float* out, float* scratch,
                  int rule, int layout, int n, int mod, int reps,
                  int rows, int row_lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mod < 1 || n < 0 || reps < 0) return (int)cudaErrorInvalidValue;
  const FloorMod fm = FloorMod::make(mod);
  if (layout == FLAT && rule == ADD)
    return launch_flat_add(ix, v, out, scratch, n, fm, reps, s);
  if (layout == FLAT && rule == LCG_BEFORE) {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)mod, s);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) flat_lcg<<<blocks(n, THREADS), THREADS, 0, s>>>(ix, v, out, n,
                                                              fm, reps);
    return (int)cudaGetLastError();
  }
  if (layout == ROW && rule == ADD)
    return launch_row<ADD>(ix, v, out, rows, row_lanes, fm, reps, s);
  if (layout == ROW && rule == LCG_BEFORE)
    return launch_row<LCG_BEFORE>(ix, v, out, rows, row_lanes, fm, reps, s);
  return (int)cudaErrorInvalidValue;
}

// Largest dynamic shared memory a block may use on this device (bytes).
int probe_scatter_max_smem(int device) { return probe::max_smem(device); }

const char* probe_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
