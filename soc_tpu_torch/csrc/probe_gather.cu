// Gather probes for Hopper (sm_90a): the gather kernel and the row-gather
// kernel of the port's gather/scatter probes (soc_tpu_torch/probes/).
//
// Replaces the Pallas gather kernels of the probe scripts:
//   probe_gather_kernel: scripts/probe_gather.py A1-A5 (pallas_call at
//     :111, :130, :148, :167, :186), scripts/probe_gather2.py W1-W4 (:102,
//     :126, :152, :177) and scripts/gather_probe.py run_pallas_take (:74);
//   probe_row_gather_kernel: scripts/probe_gather2.py RG (:204).
//
// What probe_gather_kernel computes, per lane n (one thread per lane):
//   acc = 0; for i < reps: acc = acc + t[base(n) + k_i(n) * stride]
// in the probes' order, so the sum is bit for bit the plain version's.
// The index rule k_i (template RULE):
//   ADD        k_i = (ix[n] mod M + i) mod M            (A1-A5)
//   LCG_BEFORE j = lcg(j, i, M); k_i = j, j_0 = ix[n]   (W1-W4)
//   LCG_AFTER  k_i = j; then j = lcg(j, i, M)           (run_pallas_take)
// with lcg(j, i, M) = ((j * 1103515245 + 12345 + i) wrapped to int32)
// floored-mod M. The layout (template LAYOUT) sets base and stride:
//   FLAT  the whole table, base 0, stride 1, M = its size (A1-A3, W2, take;
//         A2's (row, col) address of a [2048, 128] table is the flat one)
//   ROW   row-local, t [rows, M], ix [rows, row_lanes], base = row * M
//         (A4, W1, W3, W4)
//   COL   column-local, t [M, ncols], base = n mod ncols, stride ncols (A5)
//
// What bounds it on this card: one dependent random 4-byte load per lane
// and step. The 1 MB tables (A1-A3, A5, W1, W2, take) stay in the 50 MB L2
// after the first touch, so the rate is L2 latency over the loads in
// flight. Where a lane's row fits in shared memory (A4's 128, W4's 2560 and
// W3's 32768 floats, 128 KB), the block stages the row there first
// (STAGE): the lanes then gather from shared memory, this card's answer
// to the probes' "VMEM-resident table" question. A block then covers lanes
// of one row only. Spreading the 1 MB table over a cluster's distributed
// shared memory is later work.
//
// probe_row_gather_kernel (RG): one warp per output column k < nk. The
// warp carries j = r[k] (row 0 of the probe's index array) through the LCG
// mod M and, at every step, reads the whole table row t[j, :] (ncols
// floats, coalesced), reduces it with shuffles and adds it to acc[k]. The
// probe chains the LCG over all of its [8, 16384] indices but reads only
// j[0, :128]; the other lanes' chains feed no output and are not computed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { ADD = 0, LCG_BEFORE = 1, LCG_AFTER = 2 };
enum { FLAT = 0, ROW = 1, COL = 2 };

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;            // C's % truncates; the probes' % floors
  return r < 0 ? r + m : r;
}

// int32 wraparound as JAX computes it: multiply and add as uint32, then
// reinterpret as int32
__device__ __forceinline__ int lcg(int j, int i, int m) {
  const uint32_t x = (uint32_t)j * 1103515245u + 12345u + (uint32_t)i;
  return floor_mod((int)x, m);
}

template <int RULE, int LAYOUT, bool STAGE>
__global__ void probe_gather_kernel(const float* __restrict__ t,
                                    const int* __restrict__ ix,
                                    float* __restrict__ out, int n, int mod,
                                    int reps, int row_lanes, int ncols) {
  extern __shared__ float s_row[];
  int64_t lane, base = 0, stride = 1;
  bool valid;
  if (LAYOUT == ROW) {
    const int in_row = blockIdx.x * blockDim.x + threadIdx.x;
    lane = (int64_t)blockIdx.y * row_lanes + in_row;
    valid = in_row < row_lanes;
    base = (int64_t)blockIdx.y * mod;
  } else {
    lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    valid = lane < n;
    if (LAYOUT == COL) {
      base = lane % ncols;
      stride = ncols;
    }
  }
  const float* src = t + base;
  if (STAGE) {
    for (int k = threadIdx.x; k < mod; k += blockDim.x) s_row[k] = src[k];
    __syncthreads();
    src = s_row;
  }
  if (!valid) return;
  int j = ix[lane];
  if (RULE == ADD) j = floor_mod(j, mod);
  float acc = 0.0f;
  for (int i = 0; i < reps; ++i) {
    int k;
    if (RULE == ADD) {
      k = (j + i) % mod;          // j + i >= 0
    } else if (RULE == LCG_BEFORE) {
      j = lcg(j, i, mod);
      k = j;
    } else {
      k = j;
    }
    acc = acc + src[k * stride];
    if (RULE == LCG_AFTER) j = lcg(j, i, mod);
  }
  out[lane] = acc;
}

__global__ void probe_row_gather_kernel(const float* __restrict__ t,
                                        const int* __restrict__ r,
                                        float* __restrict__ out, int nk,
                                        int ncols, int mod, int reps) {
  const int k = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (k >= nk) return;
  int j = r[k];
  float acc = 0.0f;
  for (int i = 0; i < reps; ++i) {
    j = lcg(j, i, mod);
    const float* row = t + (int64_t)j * ncols;
    float s = 0.0f;
    for (int c = lane; c < ncols; c += 32) s += row[c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    acc = acc + s;
  }
  if (lane == 0) out[k] = acc;
}

template <int RULE, int LAYOUT, bool STAGE>
int launch(const float* t, const int* ix, float* out, int n, int mod,
           int reps, int rows, int row_lanes, int ncols,
           cudaStream_t stream) {
  auto kern = probe_gather_kernel<RULE, LAYOUT, STAGE>;
  size_t smem = 0;
  dim3 grid, block;
  if (LAYOUT == ROW) {
    block = dim3(row_lanes < 1024 ? row_lanes : 1024);
    grid = dim3((row_lanes + block.x - 1) / block.x, rows);
    if (STAGE) smem = sizeof(float) * (size_t)mod;
  } else {
    block = dim3(256);
    grid = dim3((n + 255) / 256);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, block, smem, stream>>>(t, ix, out, n, mod, reps, row_lanes,
                                      ncols);
  return (int)cudaGetLastError();
}

template <int RULE>
int launch_rule(const float* t, const int* ix, float* out, int layout,
                int stage, int n, int mod, int reps, int rows, int row_lanes,
                int ncols, cudaStream_t s) {
  switch (layout) {
    case FLAT:
      return launch<RULE, FLAT, false>(t, ix, out, n, mod, reps, rows,
                                       row_lanes, ncols, s);
    case COL:
      return launch<RULE, COL, false>(t, ix, out, n, mod, reps, rows,
                                      row_lanes, ncols, s);
    case ROW:
      return stage ? launch<RULE, ROW, true>(t, ix, out, n, mod, reps, rows,
                                             row_lanes, ncols, s)
                   : launch<RULE, ROW, false>(t, ix, out, n, mod, reps, rows,
                                              row_lanes, ncols, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the gather on `stream`; returns the cudaError_t of the launch.
// n lanes; FLAT: t [mod]; ROW: t [rows, mod], ix [rows, row_lanes];
// COL: t [mod, ncols], ix [n / ncols, ncols].
int probe_gather(const float* t, const int* ix, float* out, int rule,
                 int layout, int stage, int n, int mod, int reps, int rows,
                 int row_lanes, int ncols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (rule) {
    case ADD:
      return launch_rule<ADD>(t, ix, out, layout, stage, n, mod, reps, rows,
                              row_lanes, ncols, s);
    case LCG_BEFORE:
      return launch_rule<LCG_BEFORE>(t, ix, out, layout, stage, n, mod, reps,
                                     rows, row_lanes, ncols, s);
    case LCG_AFTER:
      return launch_rule<LCG_AFTER>(t, ix, out, layout, stage, n, mod, reps,
                                    rows, row_lanes, ncols, s);
  }
  return (int)cudaErrorInvalidValue;
}

// RG: out[k] for k < nk from t [mod, ncols] and r (row 0 of the indices).
int probe_row_gather(const float* t, const int* r, float* out, int nk,
                     int ncols, int mod, int reps, void* stream) {
  const int warps = 4;
  probe_row_gather_kernel<<<(nk + warps - 1) / warps, 32 * warps, 0,
                            (cudaStream_t)stream>>>(t, r, out, nk, ncols, mod,
                                                    reps);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block may use on this device (bytes).
int probe_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
