// One-hot tally deposit on the tensor cores for Hopper (sm_90a), the
// one-hot kernel of the port's gather/scatter probes
// (soc_tpu_torch/probes/).
//
// Replaces the Pallas MX kernels of scripts/probe_gather2.py: the deposits
// bf16x1 and bf16x2 (pallas_call at :292) and the correctness deposit
// (:332). Each lane n holds a cell index j_n < 512*512 and a value v_n;
// for r < reps (j_n first stepped by the probes' LCG mod 512*512 when
// `lcg` is set):
//   out[hi, lo] += sum_n A[n, hi] B[n, lo],  hi = j_n / 512, lo = j_n % 512,
//   A[n, h] = d_n [h == hi_n],  B[n, l] = [l == lo_n]   (one-hot, bf16)
// as bf16 products with fp32 accumulation. d_n = bf16(v_n) (split 1), or
// the two terms bf16(v_n) and bf16(v_n - bf16(v_n)) as two products
// (split 2), so out is the scatter-add of the bf16-rounded values.
//
// Design. The output is one 512 x 512 GEMM with K = lanes * reps:
// out = A^T B. Each block owns a 128 x 128 output tile and a group of
// lanes, walks its lanes in chunks of 64 and, for every chunk and rep,
// writes the chunk's one-hot A and B tiles (64 x 128 bf16 each) into
// shared memory, then its 8 warps run WMMA m16n16k16 (bf16 in, fp32
// accumulate), each warp a 64 x 32 part of the tile in registers. A tile
// row holds one non-zero at most, so the tiles are zeroed once and each
// thread sets, and after the products resets, its own lane's entries.
// At the end each block adds its tile into `out` with atomicAdd (the
// wrapper zeroes `out`), so sums agree with a plain scatter to rounding.
// It carries out every product, zeros included, as the TPU probe does:
// 512 * 512 * lanes * reps MACs a call (1.1e12 at the probe's 2^17 lanes
// and 32 reps, twice that at split 2). The tensor-core rate and the
// shared-memory traffic of the fragment loads bound it; a plain
// index_add_ of the same values moves four bytes a lane and rep instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int SIDE = 512;          // THI = TLO = 512, cells = SIDE * SIDE
constexpr int TILE = 128;          // output tile per block
constexpr int KC = 64;             // lanes per chunk (the GEMM's K step)
constexpr int LD = TILE + 8;       // padded row of a bf16 tile
constexpr int GROUPS = 32;         // lane groups (blocks per output tile)
constexpr int THREADS = 256;       // 8 warps: 2 (rows) x 4 (cols)

__device__ __forceinline__ int lcg(int j, int i, int m) {
  const uint32_t x = (uint32_t)j * 1103515245u + 12345u + (uint32_t)i;
  const int r = (int)x % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(THREADS)
probe_onehot_kernel(const int* __restrict__ ix, const float* __restrict__ v,
                    float* __restrict__ out, int n, int reps, int use_lcg,
                    int split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* s_a1 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_a2 = s_a1 + KC * LD;
  __nv_bfloat16* s_b = s_a2 + KC * LD;
  const int tid = threadIdx.x, warp = tid / 32;
  const int h0 = (blockIdx.x / (SIDE / TILE)) * TILE;
  const int l0 = (blockIdx.x % (SIDE / TILE)) * TILE;
  const int wm = warp / 4, wn = warp % 4;      // warp's 64 x 32 part

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int k = tid; k < 3 * KC * LD; k += THREADS) s_a1[k] = zero;
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.0f);

  const int per_group = (n + GROUPS - 1) / GROUPS;
  const int g0 = blockIdx.y * per_group;
  const int g1 = min(n, g0 + per_group);
  for (int c0 = g0; c0 < g1; c0 += KC) {
    // this thread's lane of the chunk (threads < KC)
    const int lane = c0 + tid;
    const bool mine = tid < KC && lane < g1;
    int j = mine ? ix[lane] : 0;
    __nv_bfloat16 d1 = zero, d2 = zero;
    if (mine) {
      const float val = v[lane];
      d1 = __float2bfloat16_rn(val);
      d2 = __float2bfloat16_rn(val - __bfloat162float(d1));
    }
    for (int r = 0; r < reps; ++r) {
      int hh = -1, ll = -1;
      if (mine) {
        if (use_lcg) j = lcg(j, r, SIDE * SIDE);
        hh = j / SIDE - h0;
        ll = j % SIDE - l0;
        if (hh >= 0 && hh < TILE) {
          s_a1[tid * LD + hh] = d1;
          s_a2[tid * LD + hh] = d2;
        } else {
          hh = -1;
        }
        if (ll >= 0 && ll < TILE) {
          s_b[tid * LD + ll] = __float2bfloat16_rn(1.0f);
        } else {
          ll = -1;
        }
      }
      __syncthreads();
      for (int p = 0; p < split; ++p) {
        const __nv_bfloat16* s_a = p == 0 ? s_a1 : s_a2;
        for (int k0 = 0; k0 < KC; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fa[4];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb[2];
          // A^T: element (h, n) of the product's left factor is s_a[n][h]
          for (int a = 0; a < 4; ++a)
            wmma::load_matrix_sync(fa[a], s_a + k0 * LD + wm * 64 + a * 16,
                                   LD);
          for (int b = 0; b < 2; ++b)
            wmma::load_matrix_sync(fb[b], s_b + k0 * LD + wn * 32 + b * 16,
                                   LD);
          for (int a = 0; a < 4; ++a)
            for (int b = 0; b < 2; ++b)
              wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
        }
      }
      __syncthreads();
      if (hh >= 0) {
        s_a1[tid * LD + hh] = zero;
        s_a2[tid * LD + hh] = zero;
      }
      if (ll >= 0) s_b[tid * LD + ll] = zero;
    }
  }

  // add the tile into out through a per-warp 16 x 16 staging area
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int lane = tid % 32;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 2; ++b) {
      wmma::store_matrix_sync(stage, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = h0 + wm * 64 + a * 16, q0 = l0 + wn * 32 + b * 16;
      for (int e = lane; e < 256; e += 32) {
        const float x = stage[e];
        if (x != 0.0f) atomicAdd(out + (r0 + e / 16) * SIDE + q0 + e % 16, x);
      }
      __syncwarp();
    }
}

}  // namespace

extern "C" {

// Launches the deposit on `stream`; returns the cudaError_t of the launch.
// ix, v [n] -> out [512, 512] (zeroed by the caller); split 1 or 2.
int probe_onehot(const int* ix, const float* v, float* out, int n, int reps,
                 int use_lcg, int split, void* stream) {
  const size_t smem = 3 * sizeof(__nv_bfloat16) * KC * LD;
  cudaError_t err = cudaFuncSetAttribute(
      probe_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((SIDE / TILE) * (SIDE / TILE), GROUPS);
  probe_onehot_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      ix, v, out, n, reps, use_lcg, split);
  return (int)cudaGetLastError();
}

const char* probe_onehot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
