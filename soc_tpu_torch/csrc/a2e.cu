// A2E stochastic-heating solve for Hopper (sm_90a), all grain sizes fused.
//
// Replaces: soc_tpu/solve/pallas_a2e.py, the Pallas kernel _a2e_kernel
// (called through solve_batch_fused) together with its scan over grain
// sizes in solve_chunk_all_sizes.
//
// What it computes, per cell c and stochastic size s (kernel_A2E.c:2-104):
//   S[j, l]  = sum_f W'[s, f, j*NE + l] * ABS[c, f]   (W' pre-folded on the
//              host in float64: W'[f, j, l] = sum_{u>=j} W[f, u, l])
//   B[j, l]  = S[j, l] - S[NE-1, l]  (j < NE-1),  B[NE-1, l] = S[NE-1, l]
//   x_0 = 1e-20;  x_j = clip(sum_{l<j} B[j, l] x_l / (tdown_j + 1e-30),
//                            0, 3e37), with the progressive 1e-20 rescale
//                            of all earlier x when x_j > 1e20
//   EMIT[c, f] += sum_l EA[s, f, l] x_l / max(sum x, 1e-35)
//   PEMIT[c, f] += EMIT_s[c, f] * align[s, c]   (when align is given)
//
// Design. The TPU kernel keeps a tile's whole folded matrix [NE*NE, tile]
// in its on-chip memory; at NE 128 that is far beyond the 227 KB of shared
// memory a Hopper block may use.
// Here one block handles T cells, one thread per cell, and loops over the
// sizes itself, so EMIT and PEMIT sum in a fixed order with no atomics
// (each thread owns its output rows). For every substitution row j the
// block stages the row block W'[:, j*NE : j*NE + j] (the l < j part: x_l
// for l >= j is still zero) in shared memory; each thread forms B[j, l]
// on the fly and accumulates the row's dot with x at the same time.
// x [NE][T], the bottom row S[NE-1] [NE][T] (computed once per size) and
// the ABS tile [NFREQ][T] stay in shared memory beside the staged row
// block: ~172 KB at NE 128, T 128, NFREQ 44, hence dynamic shared memory
// above the 48 KB default.
//
// What bounds it on this card: re-reading W' from L2 once per block and
// size (NE*NE*NFREQ*4 bytes, 2.9 MB at NE 128) and the FP32 FMAs, about
// NFREQ*NE^2/2 per cell and size, each fed by two shared-memory loads.
// T sets the reuse of every staged W' element; the wrapper picks the
// largest T in {128, 64, 32} whose shared memory fits. All arithmetic is
// FP32 (soc_tpu runs this solve at Precision.HIGHEST): no tensor cores and
// no TF32. Tensor cores, TMA and cluster multicast of W' are later work.
//
// a2e_clamp_kernel: the exact path for any sign of weights and absorbed
// values. Replaces: soc_tpu/solve/stochastic.py solve_batch (:100-145, XLA,
// no Pallas kernel), which soc_tpu runs whenever a weight or an absorbed
// value is negative (stochastic.py:262-272).
//   a[u, l] = max(sum_f ABS[c, f] W[s, u, l, f], 0)   (each entry clamped,
//             so the fold cannot move into the weights)
//   B[j, l] = sum_{u=j}^{NE-2} a[u, l] (j < NE-1),  B[NE-1, l] = a[NE-1, l]
//   then the substitution, rescale, normalisation and emission above.
// Design. The lower triangle of a (NE(NE-1)/2 floats a cell, 32.5 KB at
// NE 128) does not fit a tile of cells in shared memory, and B cannot be
// formed as a total minus a prefix (at high j the suffix is many orders
// below the total). Instead the kernel swaps the two sums of s_j:
//   s_j = sum_{l<j} B[j, l] x_l = sum_{u=j}^{NE-2} p_j[u],
//   p_j[u] = sum_{l<j} a[u, l] x_l,
// keeping p[u] per cell in shared memory. When x_j is known, column j of
// a (entries u > j) is formed from the staged column block of W and
// added into p[u] += a[u, j] x_j; the 1e-20 rescale of x scales p as well.
// Every a[u, l] is formed once, clamped, and never stored; s_j is a true
// suffix sum of non-negative terms (no cancellation). W is passed
// column-major, w_unf[s, f, l*NE + u] = W[u, l, f], so a column block is
// contiguous. Shared memory and the FMA count are those of
// a2e_all_sizes_kernel, plus NE^2/2 adds per cell and size for the suffix
// sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Normalises a cell's populations x (s_x[l * T + tid]) and adds size s's
// emission EA x into tot (and align[s, c] times it into ptot), summing the
// sizes in a fixed order: size 0 writes, the later ones add.
__device__ __forceinline__ void emit_size(
    float* s_x, int T, int tid, int64_t c, bool valid, int s,
    const float* __restrict__ ea, const float* __restrict__ align,
    float* __restrict__ tot, float* __restrict__ ptot, int nf, int ne,
    int ncells) {
  float sum = 0.0f;
  for (int l = 0; l < ne; ++l) sum += s_x[l * T + tid];
  const float denom = fmaxf(sum, 1.0e-35f);
  for (int l = 0; l < ne; ++l) s_x[l * T + tid] = s_x[l * T + tid] / denom;
  if (!valid) return;
  const float* E = ea + (int64_t)s * nf * ne;
  const float al = align ? align[(int64_t)s * ncells + c] : 0.0f;
  for (int f = 0; f < nf; ++f) {
    float em = 0.0f;
    for (int l = 0; l < ne; ++l)
      em = fmaf(E[f * ne + l], s_x[l * T + tid], em);
    const int64_t o = c * nf + f;
    tot[o] = (s == 0 ? 0.0f : tot[o]) + em;
    if (ptot) ptot[o] = (s == 0 ? 0.0f : ptot[o]) + em * al;
  }
}

__global__ void a2e_all_sizes_kernel(
    const float* __restrict__ w_fold,    // [S, NF, NE*NE]
    const float* __restrict__ tdown,     // [S, NE]
    const float* __restrict__ ea,        // [S, NF, NE]
    const float* __restrict__ absorbed,  // [C, NF]
    const float* __restrict__ align,     // [S, C] or nullptr
    float* __restrict__ tot,             // [C, NF]
    float* __restrict__ ptot,            // [C, NF] or nullptr
    int nsize, int nf, int ne, int ncells) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t c = (int64_t)blockIdx.x * T + tid;
  const bool valid = c < ncells;
  float* s_abs = smem;             // [nf][T]
  float* s_w = s_abs + nf * T;     // [nf][ne] staged row block
  float* s_x = s_w + nf * ne;      // [ne][T] populations
  float* s_bot = s_x + ne * T;     // [ne][T] bottom row S[NE-1]
  const int64_t nn = (int64_t)ne * ne;

  for (int f = 0; f < nf; ++f)
    s_abs[f * T + tid] = valid ? absorbed[c * nf + f] : 0.0f;

  for (int s = 0; s < nsize; ++s) {
    const float* W = w_fold + (int64_t)s * nf * nn;
    const float* td = tdown + (int64_t)s * ne;

    // ---- bottom row S[NE-1, l], l < NE
    __syncthreads();
    for (int i = tid; i < nf * ne; i += T) {
      const int f = i / ne, l = i - f * ne;
      s_w[f * ne + l] = W[f * nn + (int64_t)(ne - 1) * ne + l];
    }
    __syncthreads();
    for (int l = 0; l < ne; ++l) {
      float acc = 0.0f;
      for (int f = 0; f < nf; ++f)
        acc = fmaf(s_w[f * ne + l], s_abs[f * T + tid], acc);
      s_bot[l * T + tid] = acc;
      s_x[l * T + tid] = (l == 0) ? 1.0e-20f : 0.0f;
    }

    // ---- forward substitution with the overflow rescale
    for (int j = 1; j < ne; ++j) {
      float sj = 0.0f;
      if (j < ne - 1) {
        __syncthreads();
        for (int i = tid; i < nf * j; i += T) {
          const int f = i / j, l = i - f * j;
          s_w[f * ne + l] = W[f * nn + (int64_t)j * ne + l];
        }
        __syncthreads();
        for (int l = 0; l < j; ++l) {
          float acc = 0.0f;
          for (int f = 0; f < nf; ++f)
            acc = fmaf(s_w[f * ne + l], s_abs[f * T + tid], acc);
          const float b = acc - s_bot[l * T + tid];
          sj = fmaf(b, s_x[l * T + tid], sj);
        }
      } else {
        for (int l = 0; l < j; ++l)
          sj = fmaf(s_bot[l * T + tid], s_x[l * T + tid], sj);
      }
      float xj = fminf(fmaxf(sj / (td[j] + 1.0e-30f), 0.0f), 3.0e37f);
      if (xj > 1.0e20f) {
        for (int l = 0; l < j; ++l) s_x[l * T + tid] *= 1.0e-20f;
        xj *= 1.0e-20f;
      }
      s_x[j * T + tid] = xj;
    }

    emit_size(s_x, T, tid, c, valid, s, ea, align, tot, ptot, nf, ne, ncells);
  }
}

__global__ void a2e_clamp_kernel(
    const float* __restrict__ w_unf,     // [S, NF, NE*NE], [f][l*NE + u]
    const float* __restrict__ tdown,     // [S, NE]
    const float* __restrict__ ea,        // [S, NF, NE]
    const float* __restrict__ absorbed,  // [C, NF]
    const float* __restrict__ align,     // [S, C] or nullptr
    float* __restrict__ tot,             // [C, NF]
    float* __restrict__ ptot,            // [C, NF] or nullptr
    int nsize, int nf, int ne, int ncells) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t c = (int64_t)blockIdx.x * T + tid;
  const bool valid = c < ncells;
  float* s_abs = smem;             // [nf][T]
  float* s_w = s_abs + nf * T;     // [nf][ne] staged column block
  float* s_x = s_w + nf * ne;      // [ne][T] populations
  float* s_p = s_x + ne * T;       // [ne][T] p[u] = sum_{l<j} a[u,l] x_l
  const int64_t nn = (int64_t)ne * ne;

  for (int f = 0; f < nf; ++f)
    s_abs[f * T + tid] = valid ? absorbed[c * nf + f] : 0.0f;

  for (int s = 0; s < nsize; ++s) {
    const float* W = w_unf + (int64_t)s * nf * nn;
    const float* td = tdown + (int64_t)s * ne;
    for (int l = 0; l < ne; ++l) {
      s_x[l * T + tid] = (l == 0) ? 1.0e-20f : 0.0f;
      s_p[l * T + tid] = 0.0f;
    }
    for (int j = 0; j < ne; ++j) {
      if (j > 0) {
        // s_j: suffix sum over rows u = NE-2 down to j (row NE-1 alone
        // for the last step), as the exact path's reversed cumsum
        float sj;
        if (j < ne - 1) {
          sj = 0.0f;
          for (int u = ne - 2; u >= j; --u) sj += s_p[u * T + tid];
        } else {
          sj = s_p[(ne - 1) * T + tid];
        }
        float xj = fminf(fmaxf(sj / (td[j] + 1.0e-30f), 0.0f), 3.0e37f);
        if (xj > 1.0e20f) {
          for (int l = 0; l < j; ++l) s_x[l * T + tid] *= 1.0e-20f;
          for (int u = j + 1; u < ne; ++u) s_p[u * T + tid] *= 1.0e-20f;
          xj *= 1.0e-20f;
        }
        s_x[j * T + tid] = xj;
      }
      if (j == ne - 1) break;
      // column j of a, rows u > j: stage W[u, j, f] for all f
      const int nu = ne - 1 - j;
      __syncthreads();
      for (int i = tid; i < nf * nu; i += T) {
        const int f = i / nu, u = j + 1 + (i - f * nu);
        s_w[f * ne + u] = W[f * nn + (int64_t)j * ne + u];
      }
      __syncthreads();
      const float xj = s_x[j * T + tid];
      for (int u = j + 1; u < ne; ++u) {
        float acc = 0.0f;
        for (int f = 0; f < nf; ++f)
          acc = fmaf(s_w[f * ne + u], s_abs[f * T + tid], acc);
        s_p[u * T + tid] = fmaf(fmaxf(acc, 0.0f), xj, s_p[u * T + tid]);
      }
    }

    emit_size(s_x, T, tid, c, valid, s, ea, align, tot, ptot, nf, ne, ncells);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a block of `tile` cells needs
// (either kernel).
size_t a2e_smem_bytes(int nf, int ne, int tile) {
  return sizeof(float) *
         ((size_t)nf * tile + (size_t)nf * ne + 2 * (size_t)ne * tile);
}

// Largest dynamic shared memory a block may use on this device (bytes).
int a2e_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Launches the solve on `stream`; returns the cudaError_t of the launch.
int a2e_all_sizes(const float* w_fold, const float* tdown, const float* ea,
                  const float* absorbed, const float* align, float* tot,
                  float* ptot, int nsize, int nf, int ne, int ncells,
                  int tile, void* stream) {
  const size_t smem = a2e_smem_bytes(nf, ne, tile);
  cudaError_t err = cudaFuncSetAttribute(
      a2e_all_sizes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (ncells + tile - 1) / tile;
  a2e_all_sizes_kernel<<<blocks, tile, smem, (cudaStream_t)stream>>>(
      w_fold, tdown, ea, absorbed, align, tot, ptot, nsize, nf, ne, ncells);
  return (int)cudaGetLastError();
}

// The exact (clamp) solve; same arguments and shared memory as
// a2e_all_sizes, with w_unf in place of w_fold.
int a2e_clamp(const float* w_unf, const float* tdown, const float* ea,
              const float* absorbed, const float* align, float* tot,
              float* ptot, int nsize, int nf, int ne, int ncells, int tile,
              void* stream) {
  const size_t smem = a2e_smem_bytes(nf, ne, tile);
  cudaError_t err = cudaFuncSetAttribute(
      a2e_clamp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (ncells + tile - 1) / tile;
  a2e_clamp_kernel<<<blocks, tile, smem, (cudaStream_t)stream>>>(
      w_unf, tdown, ea, absorbed, align, tot, ptot, nsize, nf, ne, ncells);
  return (int)cudaGetLastError();
}

const char* a2e_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
