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
// What bounds it on this card: random 4-byte loads. The 1 MB tables (A1-A3,
// A5, W2, take; W1's eight copies, 8 MB) stay in the 50 MB L2 after the
// first touch, and a random load costs L2 one 32-byte sector request. On
// the LCG rows (take, W1, W2) the launch shape moved the time, not more
// loads in flight (PERF.md; NVIDIA H100 80GB HBM3, 700 W): W1 and W2 ran 8%
// and 1% faster in blocks of up to 1024 lanes of one row than in blocks of
// 128, take 2% faster with 4 loads in flight a lane than with 16, and the
// L1 carveout moved no row. The design:
//   - indices generated ahead: the index rules never depend on a loaded
//     value, so a lane computes U indices, issues U independent loads,
//     then adds them in step order (a tail for reps % U): the same adds
//     in the same order; U is 4 for loads from global memory and 16 for
//     loads from shared memory (there W4 ran 10% faster than with 4);
//   - no division in the loop: ADD steps its index with a compare and
//     reset, and the LCG's floored modulus takes a mask for a power of two
//     (the 262,144-float tables) and otherwise a multiply-high by a
//     reciprocal worked out on the host (FloorMod);
//   - shared memory where a lane's data fits, staged with cp.async: a row
//     (ROW: A4's 128, W4's 2560 and W3's 32,768 floats) or, for the
//     column-local layout (COL, A5), a slab of up to 16 columns (16 x 2048
//     floats, 128 KB), where A5's direct form read one sector per load.
// A random walk over a 1 MB table (take, W1, W2) stays with L2: a copy of
// the table spread over a cluster's distributed shared memory and slices
// of it staged block by block, with the values passed through a scratch
// array, were both measured and both ran slower (PERF.md).

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

constexpr int GATHER_U = 4;         // loads in flight a lane: from L2
constexpr int SHARED_U = 16;        // and from shared memory
constexpr int GATHER_THREADS = 256; // unstaged FLAT and COL blocks
constexpr int COL_THREADS = 256;    // staged-column blocks
constexpr int COL_GROUP = 16;       // most columns a staged block holds

// 4-byte asynchronous copy global -> shared (any alignment), and the wait
// for every copy this thread queued
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies n floats from src to s[0, n) with the block's threads, then
// waits for them and for the block.
__device__ __forceinline__ void stage(float* s, const float* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) cp_async4(s + k, src + k);
  cp_async_wait_all();
  __syncthreads();
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;            // C's % truncates; the probes' % floors
  return r < 0 ? r + m : r;
}

// x floored-mod d for every int32 x, d >= 1 fixed per launch, without a
// division: a mask where d is a power of two, else the round-up method of
// Granlund and Montgomery on u = x + 2^31 (as uint32): q = u / d =
// (t + ((u - t) >> sh1)) >> sh2 with t = umulhi(magic, u), and x mod d =
// (u mod d - 2^31 mod d) mod d.
struct FloorMod {
  int d;
  uint32_t magic, off;  // off = 2^31 mod d
  int sh1, sh2;
  bool pow2;

  static FloorMod make(int d) {
    FloorMod f{};
    f.d = d;
    f.pow2 = (d & (d - 1)) == 0;
    int l = 0;
    while ((1ull << l) < (uint64_t)d) ++l;        // 2^(l-1) < d <= 2^l
    f.magic = (uint32_t)((((1ull << l) - d) << 32) / d + 1);
    f.sh1 = l < 1 ? l : 1;
    f.sh2 = l > 1 ? l - 1 : 0;
    f.off = (uint32_t)((1ull << 31) % (uint64_t)d);
    return f;
  }

  __device__ __forceinline__ int operator()(int x) const {
    if (pow2) return x & (d - 1);
    const uint32_t u = (uint32_t)x ^ 0x80000000u;
    const uint32_t t = __umulhi(magic, u);
    const uint32_t q = (t + ((u - t) >> sh1)) >> sh2;
    const uint32_t r = u - q * (uint32_t)d;
    return r >= off ? (int)(r - off) : (int)(r + (uint32_t)d - off);
  }
};

// int32 wraparound as JAX computes it: multiply and add as uint32, then
// reinterpret as int32, then the floored modulus
__device__ __forceinline__ int lcg(int j, int i, const FloorMod& fm) {
  const uint32_t x = (uint32_t)j * 1103515245u + 12345u + (uint32_t)i;
  return fm((int)x);
}

// A lane's walk through its indices: next(i) is k_i, the index of step i.
template <int RULE>
struct Walk {
  int j;
  FloorMod fm;

  __device__ __forceinline__ Walk(int ix, const FloorMod& f) : fm(f) {
    j = RULE == ADD ? floor_mod(ix, f.d) : ix;
  }

  __device__ __forceinline__ int next(int i) {
    if (RULE == ADD) {
      const int k = j;
      j = j + 1 == fm.d ? 0 : j + 1;
      return k;
    }
    if (RULE == LCG_BEFORE) {
      j = lcg(j, i, fm);
      return j;
    }
    const int k = j;
    j = lcg(j, i, fm);
    return k;
  }
};

template <bool LDG>
__device__ __forceinline__ float load(const float* p) {
  return LDG ? __ldg(p) : *p;
}

// sum_{i < reps} src[k_i * stride], added in step order, U loads issued
// before their adds: GATHER_U from global memory (LDG), SHARED_U from
// shared memory.
template <int RULE, bool LDG>
__device__ __forceinline__ float walk_sum(Walk<RULE> w, const float* src,
                                          int64_t stride, int reps) {
  constexpr int U = LDG ? GATHER_U : SHARED_U;
  float acc = 0.0f;
  int i = 0;
  for (; i + U <= reps; i += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = load<LDG>(src + (int64_t)w.next(i + u) * stride);
#pragma unroll
    for (int u = 0; u < U; ++u) acc = acc + v[u];
  }
  for (; i < reps; ++i)
    acc = acc + load<LDG>(src + (int64_t)w.next(i) * stride);
  return acc;
}

// FLAT, ROW and COL from global memory, and ROW with the lane's row staged
// in shared memory (STAGE). A ROW block covers lanes of one row only.
template <int RULE, int LAYOUT, bool STAGE>
__global__ void probe_gather_kernel(const float* __restrict__ t,
                                    const int* __restrict__ ix,
                                    float* __restrict__ out, int n,
                                    FloorMod fm, int reps, int row_lanes,
                                    int ncols) {
  extern __shared__ float s_row[];
  int64_t lane, base = 0, stride = 1;
  bool valid;
  if (LAYOUT == ROW) {
    const int in_row = blockIdx.x * blockDim.x + threadIdx.x;
    lane = (int64_t)blockIdx.y * row_lanes + in_row;
    valid = in_row < row_lanes;
    base = (int64_t)blockIdx.y * fm.d;
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
    stage(s_row, src, fm.d);
    if (valid)
      out[lane] = walk_sum<RULE, false>(Walk<RULE>(ix[lane], fm), s_row, 1,
                                        reps);
  } else if (valid) {
    out[lane] = walk_sum<RULE, true>(Walk<RULE>(ix[lane], fm), src, stride,
                                     reps);
  }
}

// COL with a slab of `cg` columns staged: block (x, y) holds columns
// [x cg, (x + 1) cg) of t [M, ncols] as s_col[M][cg] (cg a power of two)
// and walks the lanes of rows [y rb, (y + 1) rb) of ix [nrows, ncols] in
// those columns. The column groups lie on grid.x, which is not capped at
// 65535 as grid.y is.
template <int RULE>
__global__ void probe_gather_cols_kernel(const float* __restrict__ t,
                                         const int* __restrict__ ix,
                                         float* __restrict__ out, int nrows,
                                         FloorMod fm, int reps, int ncols,
                                         int cg, int rb) {
  extern __shared__ float s_col[];
  const int c0 = blockIdx.x * cg, log_cg = __ffs(cg) - 1;
  for (int i = threadIdx.x; i < fm.d * cg; i += blockDim.x)
    cp_async4(s_col + i,
              t + (int64_t)(i >> log_cg) * ncols + c0 + (i & (cg - 1)));
  cp_async_wait_all();
  __syncthreads();
  const int c = threadIdx.x & (cg - 1);
  const int r1 = min(nrows, (int)(blockIdx.y + 1) * rb);
  for (int r = blockIdx.y * rb + (threadIdx.x >> log_cg); r < r1;
       r += blockDim.x >> log_cg) {
    const int64_t lane = (int64_t)r * ncols + c0 + c;
    out[lane] = walk_sum<RULE, false>(Walk<RULE>(ix[lane], fm), s_col + c,
                                      cg, reps);
  }
}

__global__ void probe_row_gather_kernel(const float* __restrict__ t,
                                        const int* __restrict__ r,
                                        float* __restrict__ out, int nk,
                                        int ncols, FloorMod fm, int reps) {
  const int k = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (k >= nk) return;
  int j = r[k];
  float acc = 0.0f;
  for (int i = 0; i < reps; ++i) {
    j = lcg(j, i, fm);
    const float* row = t + (int64_t)j * ncols;
    float s = 0.0f;
    for (int c = lane; c < ncols; c += 32) s += row[c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    acc = acc + s;
  }
  if (lane == 0) out[k] = acc;
}

int max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

template <class K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int RULE, int LAYOUT, bool STAGE>
int launch(const float* t, const int* ix, float* out, int n, FloorMod fm,
           int reps, int rows, int row_lanes, int ncols,
           cudaStream_t stream) {
  auto kern = probe_gather_kernel<RULE, LAYOUT, STAGE>;
  size_t smem = 0;
  dim3 grid, block;
  if (LAYOUT == ROW) {
    // a block covers lanes of one row, up to 1024 of them
    block = dim3(row_lanes < 1024 ? row_lanes : 1024);
    grid = dim3((row_lanes + block.x - 1) / block.x, rows);
    if (STAGE) smem = sizeof(float) * (size_t)fm.d;
  } else {
    block = dim3(GATHER_THREADS);
    grid = dim3((n + GATHER_THREADS - 1) / GATHER_THREADS);
  }
  int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<grid, block, smem, stream>>>(t, ix, out, n, fm, reps, row_lanes,
                                      ncols);
  return (int)cudaGetLastError();
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return sms;
}

// COL staged: the most columns (a power of two dividing ncols, at most
// COL_GROUP) whose slab fits in shared memory; blocks of rb rows, at most
// one a SM, so that the grid runs in one wave.
template <int RULE>
int launch_cols(const float* t, const int* ix, float* out, int n,
                FloorMod fm, int reps, int ncols, cudaStream_t stream) {
  const int cap = max_smem(), sms = sm_count();
  if (cap < 0 || sms < 0) return (int)cudaErrorInvalidValue;
  int cg = COL_GROUP;
  while (cg > 1 &&
         (ncols % cg != 0 || sizeof(float) * (size_t)cg * fm.d > (size_t)cap))
    cg /= 2;
  const size_t smem = sizeof(float) * (size_t)cg * fm.d;
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  const int nrows = n / ncols, groups = ncols / cg;
  const int per_group = sms / groups > 1 ? sms / groups : 1;
  const int rb = (nrows + per_group - 1) / per_group;
  auto kern = probe_gather_cols_kernel<RULE>;
  const int err = set_smem(kern, smem);
  if (err != 0) return err;
  kern<<<dim3(groups, (nrows + rb - 1) / rb), COL_THREADS, smem, stream>>>(
      t, ix, out, nrows, fm, reps, ncols, cg, rb);
  return (int)cudaGetLastError();
}

template <int RULE>
int launch_rule(const float* t, const int* ix, float* out, int layout,
                int stage, int n, FloorMod fm, int reps, int rows,
                int row_lanes, int ncols, cudaStream_t s) {
  switch (layout) {
    case FLAT:
      return launch<RULE, FLAT, false>(t, ix, out, n, fm, reps, rows,
                                       row_lanes, ncols, s);
    case COL:
      return stage ? launch_cols<RULE>(t, ix, out, n, fm, reps, ncols, s)
                   : launch<RULE, COL, false>(t, ix, out, n, fm, reps, rows,
                                              row_lanes, ncols, s);
    case ROW:
      return stage ? launch<RULE, ROW, true>(t, ix, out, n, fm, reps, rows,
                                             row_lanes, ncols, s)
                   : launch<RULE, ROW, false>(t, ix, out, n, fm, reps, rows,
                                              row_lanes, ncols, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the gather on `stream`; returns the cudaError_t of the launch.
// n lanes; FLAT: t [mod]; ROW: t [rows, mod], ix [rows, row_lanes];
// COL: t [mod, ncols], ix [n / ncols, ncols]. stage: ROW, the row, or
// COL, a slab of columns, is copied to shared memory (it must fit).
int probe_gather(const float* t, const int* ix, float* out, int rule,
                 int layout, int stage, int n, int mod, int reps, int rows,
                 int row_lanes, int ncols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mod < 1) return (int)cudaErrorInvalidValue;
  const FloorMod fm = FloorMod::make(mod);
  switch (rule) {
    case ADD:
      return launch_rule<ADD>(t, ix, out, layout, stage, n, fm, reps, rows,
                              row_lanes, ncols, s);
    case LCG_BEFORE:
      return launch_rule<LCG_BEFORE>(t, ix, out, layout, stage, n, fm, reps,
                                     rows, row_lanes, ncols, s);
    case LCG_AFTER:
      return launch_rule<LCG_AFTER>(t, ix, out, layout, stage, n, fm, reps,
                                    rows, row_lanes, ncols, s);
  }
  return (int)cudaErrorInvalidValue;
}

// RG: out[k] for k < nk from t [mod, ncols] and r (row 0 of the indices).
int probe_row_gather(const float* t, const int* r, float* out, int nk,
                     int ncols, int mod, int reps, void* stream) {
  const int warps = 4;
  probe_row_gather_kernel<<<(nk + warps - 1) / warps, 32 * warps, 0,
                            (cudaStream_t)stream>>>(
      t, r, out, nk, ncols, FloorMod::make(mod), reps);
  return (int)cudaGetLastError();
}

// Loads in flight a lane of the gather kernel (its unroll depth): from
// global memory (staged 0) or from a row or columns staged in shared
// memory (staged 1).
int probe_gather_unroll(int staged) { return staged ? SHARED_U : GATHER_U; }

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
