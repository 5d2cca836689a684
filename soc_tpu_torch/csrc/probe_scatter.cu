// Scatter-add probe for Hopper (sm_90a), the scatter kernel of the port's
// gather/scatter probes (soc_tpu_torch/probes/).
//
// Replaces the Pallas scatter kernels of the probe scripts:
//   S1 vector scatter-add, scripts/probe_gather.py (pallas_call at :207):
//     out = 0; for i < reps: out[(ix[n] + i) mod M] += v[n]
//   S2 lane-local scatter-add, scripts/probe_gather2.py (:230):
//     a = 0; j = ix; for i < reps: j = lcg(j, i, M); a[s, j[s, l]] += v[s, l]
//     over rows s of M lanes' slots (M = 128)
// with the same index rules as probe_gather.cu (ADD, LCG_BEFORE).
//
// Design. One thread per lane, looping over the reps. FLAT (S1) adds with
// global atomicAdd into out [M] (1 MB, which stays in L2): what bounds it
// is the L2 atomic rate and the collisions of random addresses. ROW (S2)
// gives each block one row: the block adds into the row's M slots in
// shared memory with shared-memory atomics, then writes the row out, so
// device memory sees each output once. The order of the atomic adds
// changes from run to run, so sums agree with the plain version to
// rounding, not bit for bit. The wrapper zeroes `out` for FLAT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { ADD = 0, LCG_BEFORE = 1 };
enum { FLAT = 0, ROW = 1 };

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;            // C's % truncates; the probes' % floors
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int lcg(int j, int i, int m) {
  const uint32_t x = (uint32_t)j * 1103515245u + 12345u + (uint32_t)i;
  return floor_mod((int)x, m);
}

template <int RULE>
__device__ __forceinline__ int step(int& j, int i, int mod) {
  if (RULE == ADD) return (j + i) % mod;   // j already reduced, >= 0
  j = lcg(j, i, mod);
  return j;
}

template <int RULE>
__global__ void probe_scatter_flat(const int* __restrict__ ix,
                                   const float* __restrict__ v,
                                   float* __restrict__ out, int n, int mod,
                                   int reps) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int j = ix[lane];
  if (RULE == ADD) j = floor_mod(j, mod);
  const float val = v[lane];
  for (int i = 0; i < reps; ++i) atomicAdd(out + step<RULE>(j, i, mod), val);
}

template <int RULE>
__global__ void probe_scatter_row(const int* __restrict__ ix,
                                  const float* __restrict__ v,
                                  float* __restrict__ out, int mod,
                                  int row_lanes, int reps) {
  extern __shared__ float s_a[];
  const int64_t row = blockIdx.x;
  for (int k = threadIdx.x; k < mod; k += blockDim.x) s_a[k] = 0.0f;
  __syncthreads();
  for (int l = threadIdx.x; l < row_lanes; l += blockDim.x) {
    const int64_t lane = row * row_lanes + l;
    int j = ix[lane];
    if (RULE == ADD) j = floor_mod(j, mod);
    const float val = v[lane];
    for (int i = 0; i < reps; ++i) atomicAdd(s_a + step<RULE>(j, i, mod), val);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < mod; k += blockDim.x)
    out[row * mod + k] = s_a[k];
}

template <int RULE>
int launch(const int* ix, const float* v, float* out, int layout, int n,
           int mod, int reps, int rows, int row_lanes, cudaStream_t s) {
  if (layout == FLAT) {
    probe_scatter_flat<RULE><<<(n + 255) / 256, 256, 0, s>>>(ix, v, out, n,
                                                             mod, reps);
  } else {
    const size_t smem = sizeof(float) * (size_t)mod;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          probe_scatter_row<RULE>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int threads = row_lanes < 1024 ? row_lanes : 1024;
    probe_scatter_row<RULE><<<rows, threads, smem, s>>>(ix, v, out, mod,
                                                        row_lanes, reps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scatter-add on `stream`; returns the cudaError_t of the
// launch. FLAT: ix, v [n] -> out [mod] (zeroed by the caller); ROW: ix, v
// [rows, row_lanes] -> out [rows, mod].
int probe_scatter(const int* ix, const float* v, float* out, int rule,
                  int layout, int n, int mod, int reps, int rows,
                  int row_lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rule == ADD)
    return launch<ADD>(ix, v, out, layout, n, mod, reps, rows, row_lanes, s);
  if (rule == LCG_BEFORE)
    return launch<LCG_BEFORE>(ix, v, out, layout, n, mod, reps, rows,
                              row_lanes, s);
  return (int)cudaErrorInvalidValue;
}

const char* probe_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
