// Tally deposit into a 1 MB table split over the shared memory of eight
// blocks, for Hopper (sm_90a): the one-hot kernel of the port's
// gather/scatter probes (soc_tpu_torch/probes/).
//
// Replaces the Pallas MX kernels of scripts/probe_gather2.py: the deposits
// bf16x1 and bf16x2 (pallas_call at :292) and the correctness deposit
// (:332). Each lane n holds a cell index j_n < 512*512 and a value v_n;
// for r < reps (j_n first stepped by the probes' LCG mod 512*512 when
// `lcg` is set) it adds d_n into out[j_n], with d_n = bf16(v_n) (split 1)
// or bf16(v_n) + bf16(v_n - bf16(v_n)) summed in float32 (split 2): the
// scatter-add of the bf16-rounded values that the TPU computes as one-hot
// products on its matrix unit.
//
// What bounds it: the deposits are random adds into a 1 MB table, with
// four bytes of index and four of value a lane, so the rate of random adds
// sets the time, not the bytes or the multipliers. A one-hot product does
// 512 * 512 MACs for every add (1.1e12 at the probe's 2^17 lanes and 32
// reps); the previous design did all of them on the tensor cores and took
// 187x the time of one index_add_.
//
// Design. The table is privatised in shared memory: a group of 8 blocks
// holds one copy, each block 1/8 of it, 32,768 cells (128 KB of dynamic
// shared memory); cell j lives in block j >> 15 of its group, at word
// j & 32767. Every block of a group walks all of the group's lanes (the
// LCG chain of a lane is sequential in r; lanes are independent, one
// thread each), forms d once per lane, and adds with a shared-memory
// atomicAdd only the deposits that fall in its own slice; the chains are
// walked 8 times, but no add leaves the SM. Then each block adds its slice
// into `out` (zeroed by the wrapper) with 16-byte float4 atomics (sm_90),
// skipping all-zero groups, so a flush adds no more than its deposits.
// The number of groups follows the work: one per 1024 lanes (a lane for
// every thread), at most as many as are resident on the card at once.
// Sums are taken in another order than the plain version's: equal to
// rounding. Sending each deposit once, to its owner's word through a
// thread-block cluster's distributed shared memory, was measured first on
// an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): its remote atomics ran at
// 22G deposits a second, this design at 77-87G, index_add_ at 69G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SIDE = 512;
constexpr int CELLS = SIDE * SIDE;       // 262,144 cells, 1 MB of float32
constexpr int SLICES = 8;                // blocks holding one table
constexpr int SLICE_BITS = 15;
constexpr int SLICE = CELLS / SLICES;    // cells a block holds
constexpr int THREADS = 1024;

static_assert(SLICE == 1 << SLICE_BITS, "a slice is 2^15 cells");

__device__ __forceinline__ int lcg(int j, int i) {
  const uint32_t x = (uint32_t)j * 1103515245u + 12345u + (uint32_t)i;
  const int r = (int)x % CELLS;
  return r < 0 ? r + CELLS : r;
}

__global__ void __launch_bounds__(THREADS)
probe_onehot_kernel(const int* __restrict__ ix, const float* __restrict__ v,
                    float* __restrict__ out, int n, int reps, int use_lcg,
                    int split) {
  extern __shared__ float4 s_tab4[];     // [SLICE / 4]
  float* s_tab = reinterpret_cast<float*>(s_tab4);
  const int slice = blockIdx.x % SLICES;
  const int group = blockIdx.x / SLICES, groups = gridDim.x / SLICES;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < SLICE / 4; i += THREADS) s_tab4[i] = zero;
  __syncthreads();

  for (int lane = group * THREADS + threadIdx.x; lane < n;
       lane += groups * THREADS) {
    int j = ix[lane];
    const float val = v[lane];
    const float d1 = __bfloat162float(__float2bfloat16_rn(val));
    const float d = split == 1
        ? d1 : d1 + __bfloat162float(__float2bfloat16_rn(val - d1));
    for (int r = 0; r < reps; ++r) {
      if (use_lcg) j = lcg(j, r);
      if ((j >> SLICE_BITS) == slice)
        atomicAdd(s_tab + (j & (SLICE - 1)), d);
    }
  }
  __syncthreads();

  float4* dst = reinterpret_cast<float4*>(out) + (size_t)slice * (SLICE / 4);
  for (int i = threadIdx.x; i < SLICE / 4; i += THREADS) {
    const float4 x = s_tab4[i];
    if (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f)
      atomicAdd(dst + i, x);
  }
}

// Groups of 8 blocks that a deposit of n lanes runs on, on the current
// device: one per 1024 lanes, at least 1, at most as many as are resident
// at once; negative: a CUDA error.
int groups_for(int n) {
  static int fit[64] = {0};   // groups resident at once, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  int most = device < 64 ? fit[device] : 0;
  if (most == 0) {
    int sms = 0, blocks = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaFuncSetAttribute(probe_onehot_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SLICE * (int)sizeof(float));
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, probe_onehot_kernel, THREADS, SLICE * sizeof(float));
    if (err != cudaSuccess) return -(int)err;
    most = sms * blocks / SLICES;
    if (most < 1) return -(int)cudaErrorInvalidConfiguration;
    if (device < 64) fit[device] = most;
  }
  const int want = (n + THREADS - 1) / THREADS;
  return want < 1 ? 1 : want > most ? most : want;
}

}  // namespace

extern "C" {

// Launches the deposit on `stream`; returns the cudaError_t of the launch.
// ix, v [n] -> out [512, 512] (zeroed by the caller); split 1 or 2.
int probe_onehot(const int* ix, const float* v, float* out, int n, int reps,
                 int use_lcg, int split, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SLICE * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  const int groups = groups_for(n);
  if (groups < 0) return -groups;
  probe_onehot_kernel<<<SLICES * groups, THREADS, SLICE * sizeof(float),
                        (cudaStream_t)stream>>>(ix, v, out, n, reps, use_lcg,
                                                split);
  return (int)cudaGetLastError();
}

const char* probe_onehot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
