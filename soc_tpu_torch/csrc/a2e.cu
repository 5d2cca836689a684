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
// What bounds it: the FP32 FMAs of the substitution, NFREQ * NE^2 / 2 a
// cell and size (soc_tpu runs the solve at Precision.HIGHEST, and the
// fold's S[j] - S[NE-1] cancels, so no tensor cores and no TF32), and
// the shared-memory loads that feed them. The TPU kernel keeps a tile's
// whole folded matrix [NE*NE, tile] on chip; a Hopper block cannot (227 KB).
//
// Design (a2e_all_sizes_kernel). One thread owns one cell: its
// populations x [NE] (a column of shared memory) and its output rows, and
// it loops over the sizes itself, so EMIT and PEMIT sum in a fixed order
// with no atomics and a cell's bits do not depend on where it sits in the
// launch. The substitution is reordered so that each x_l feeds a chunk of
// independent FMAs instead of one dependent chain:
//   r[f] = sum_{l<j} W'[f, j, l] x_l        (a chunk of f in registers)
//   s_j  = sum_f ABS[f] r[f] - q_j,  q_j = sum_{l<j} S[NE-1, l] x_l
// q is a running sum per cell: S[NE-1, l] is formed (NFREQ FMAs) when x_l
// is set, and q is scaled with x when the rescale fires; the bottom row
// takes no shared memory. The weights are stored row by row, frequencies
// last and zero-padded to NFP = 4 ceil(NFREQ/4) (w_fold [S, NE, NE, NFP]),
// so a row's l < j part is one contiguous run: it is staged in shared
// memory as [l][f] and read with 16-byte loads that every thread of the
// block shares (broadcast). At NFREQ 44 one step over l is 1 load of x_l
// and 11 of W', for 44 FMAs: 3.7 FMAs per shared load (the previous design
// did 0.5). Frequencies come in register chunks of at most 48 (any NFREQ,
// chunk by chunk); ABS stays in registers when one chunk holds them all,
// else in shared memory. The staged weights stream through two buffers
// with cp.async: a row (or, where shared memory is short, a run of `lc`
// columns of it) is copied while the previous one computes, one wait and
// one barrier each. Shared memory is x [NE][tile] plus the two buffers,
// 110 KB at NE 128, NFREQ 44, tile 128: two blocks, 8 warps, per SM
// (a2e_fold_smem_bytes; the wrapper picks tile and lc,
// a2e_kernel.pick_fold_config). Each staged W' element serves the block's
// tile cells, so W' is read from L2 once per block and size.
//
// a2e_clamp_kernel: the exact path for any sign of weights and absorbed
// values. Replaces: soc_tpu/solve/stochastic.py solve_batch (:100-145, XLA,
// no Pallas kernel), which soc_tpu runs whenever a weight or an absorbed
// value is negative (stochastic.py:262-272).
//   a[u, l] = max(sum_f ABS[c, f] W[s, u, l, f], 0)   (each entry clamped,
//             so the fold cannot move into the weights)
//   B[j, l] = sum_{u=j}^{NE-2} a[u, l] (j < NE-1),  B[NE-1, l] = a[NE-1, l]
//   then the substitution, rescale, normalisation and emission above.
// What bounds it: the same FP32 FMAs as a2e_all_sizes, NFREQ NE(NE-1)/2 a
// cell and size, and the shared-memory loads that feed them.
// Design. The lower triangle of a does not fit a tile of cells in shared
// memory, and B cannot be formed as a total minus a prefix (at high j the
// suffix is many orders below the total). So the two sums of s_j swap:
//   s_j = sum_{l<j} B[j, l] x_l = sum_{u=j}^{NE-2} p_j[u],
//   p_j[u] = sum_{l<j} a[u, l] x_l.
// When x_j is known, column j of a (rows u > j) is formed and added into
// p[u] += a[u, j] x_j; the same loop sums the new p[u] for u <= NE-2,
// which is s_{j+1} (non-negative terms, no cancellation), so no separate
// suffix pass. Every a[u, l] is formed once, clamped, and never stored.
// One thread owns one cell and one shared slot per population: slot u
// holds p[u] until step u and x_u after it (p[u] is spent in s_u, the
// step that sets x_u), so x and p together take [NE][tile]; the 1e-20
// rescale scales every slot but j. The weights are stored column by
// column, frequencies last and zero-padded to NFP (w_unf [S, NE (column
// l), NE (row u), NFP]), so column j's live rows u > j are one contiguous
// run: it streams through two shared buffers with cp.async (one wait and
// one barrier a run of `lr` rows) and is read with 16-byte loads that the
// whole block shares. ABS stays in registers when one chunk of at most 48
// frequencies holds it (else chunk by chunk from shared memory), and
// CLAMP_ROWS rows are formed a pass with independent sums: at NFREQ 44 an
// entry is 11 broadcast loads for 44 FMAs. Time follows the rows a pass
// and the resident warps (8 rows and 12 warps ran 1.7x faster than 2 rows
// and 8 warps at the pipeline's shape, PERF.md), so at NE 128, NFREQ 44
// and tile 128 the columns stream in runs of 32 rows: 64 KB of slots + two
// 5.5 KB buffers, three blocks (12 warps) per SM (a2e_clamp_smem_bytes;
// a2e_kernel.pick_clamp_config picks tile and lr from the shape and card
// alone). A
// cell's sums run in one order whatever the tile, the run length and the
// cell's place in the launch, so shards add up as one launch does.
//
// The global-memory form of both kernels (template argument G). The shared
// form's ceiling is a cell's populations, 4 NE bytes a thread, and, beyond
// one register chunk, its ABS, 4 NFP bytes a thread, in shared memory: at
// tile 32 about NE 1790 at NFREQ 44 and NFREQ 1000 at NE 256 on an H100.
// Beyond it (a2e_kernel._pick_config takes this form only where no tile
// and run fit) the populations (the clamp kernel's slots) live in a scratch
// [NE][CP] in device memory that the wrapper allocates, CP the cell count
// rounded up to whole blocks, indexed l * CP + c so that a warp's reads
// coalesce, and ABS is read from a transposed, zero-padded copy [NFP][CP]
// (also coalesced; chosen over [C, NF], whose per-thread rows a warp reads
// 4 NF bytes apart), one register chunk of at most 48 frequencies at a
// time. Shared memory holds the two staging buffers alone, in runs that
// shrink until both fit; where not even a run of 8 fits (NFREQ above about
// 3200), a unit is a whole row (column) read through L2 without staging.
// The arithmetic, and the order of every sum, is the shared form's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int FOLD_THREADS = 128;  // the largest tile (cells per block)
constexpr int FOLD_C4 = 12;        // float4 groups in a register chunk
constexpr int FOLD_CH = 4 * FOLD_C4;

// Normalises a cell's populations x (xp[l * xs]) and adds size s's
// emission EA x into tot (and align[s, c] times it into ptot), summing the
// sizes in a fixed order: size 0 writes, the later ones add.
template <typename I>
__device__ __forceinline__ void emit_size(
    float* xp, I xs, int64_t c, bool valid, int s,
    const float* __restrict__ ea, const float* __restrict__ align,
    float* __restrict__ tot, float* __restrict__ ptot, int nf, int ne,
    int ncells) {
  float sum = 0.0f;
  for (int l = 0; l < ne; ++l) sum += xp[l * xs];
  const float denom = fmaxf(sum, 1.0e-35f);
  for (int l = 0; l < ne; ++l) xp[l * xs] = xp[l * xs] / denom;
  if (!valid) return;
  const float* E = ea + (int64_t)s * nf * ne;
  const float al = align ? align[(int64_t)s * ncells + c] : 0.0f;
  for (int f = 0; f < nf; ++f) {
    float em = 0.0f;
    for (int l = 0; l < ne; ++l)
      em = fmaf(E[f * ne + l], xp[l * xs], em);
    const int64_t o = c * nf + f;
    tot[o] = (s == 0 ? 0.0f : tot[o]) + em;
    if (ptot) ptot[o] = (s == 0 ? 0.0f : ptot[o]) + em * al;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A unit of the stream of staged weights: size s, substitution row j,
// part u. It holds columns [u*lc, u*lc + cols) of row j (none for the last
// row, whose sum is q alone) and, for u == 0, the bottom row's column j-1
// in slot lc.
struct Unit {
  int s, j, u;
};

__device__ __forceinline__ int unit_cols(Unit t, int ne, int lc) {
  return t.j == ne - 1 ? 0 : min(lc, t.j - t.u * lc);
}

__device__ __forceinline__ bool last_unit_of_row(Unit t, int ne, int lc) {
  return t.j == ne - 1 || (t.u + 1) * lc >= t.j;
}

__device__ __forceinline__ Unit next_unit(Unit t, int ne, int lc) {
  if (!last_unit_of_row(t, ne, lc)) return {t.s, t.j, t.u + 1};
  if (t.j + 1 < ne) return {t.s, t.j + 1, 0};
  return {t.s + 1, 1, 0};
}

// Queues the copies of unit t into buf ([lc + 1][nfp4] float4) and
// commits them as one cp.async group.
__device__ __forceinline__ void stage_unit(float4* buf,
                                           const float4* __restrict__ w,
                                           Unit t, int ne, int nfp4, int lc,
                                           int tid, int T) {
  const float4* W = w + (int64_t)t.s * ne * ne * nfp4;
  const float4* row = W + ((int64_t)t.j * ne + t.u * lc) * nfp4;
  const int n = unit_cols(t, ne, lc) * nfp4;
  for (int i = tid; i < n; i += T) cp_async16(buf + i, row + i);
  if (t.u == 0) {
    const float4* bot = W + ((int64_t)(ne - 1) * ne + (t.j - 1)) * nfp4;
    for (int i = tid; i < nfp4; i += T)
      cp_async16(buf + lc * nfp4 + i, bot + i);
  }
  cp_async_commit();
}

// One register chunk, float4 groups [g0, g0 + C4), of a unit (staged, or
// in device memory): adds sum_f ABS[f] sum_l W'[f, j, l] x_l over the
// unit's columns (wrow, the column l0 first) into dot and, with `bottom`,
// sum_f ABS[f] W'[f, NE-1, j-1] (wbot) into bot. `a` holds the chunk's ABS;
// with `multi` (more than one chunk) it is loaded here from ap[f * xs].
template <int C4, typename I>
__device__ __forceinline__ void chunk_unit(
    const float4* wrow, const float4* wbot, int nfp4, int g0, const float* xp,
    I xs, int l0, int ncols, bool bottom, bool multi, const float* ap,
    float (&a)[FOLD_CH], float& dot, float& bot) {
  if (multi) {
#pragma unroll
    for (int k = 0; k < 4 * C4; ++k) a[k] = ap[(4 * g0 + k) * xs];
  }
  if (bottom) {
    const float4* wb = wbot + g0;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
#pragma unroll
    for (int k = 0; k < C4; ++k) {
      const float4 w4 = wb[k];
      b0 = fmaf(a[4 * k], w4.x, b0);
      b1 = fmaf(a[4 * k + 1], w4.y, b1);
      b2 = fmaf(a[4 * k + 2], w4.z, b2);
      b3 = fmaf(a[4 * k + 3], w4.w, b3);
    }
    bot += (b0 + b1) + (b2 + b3);
  }
  if (ncols == 0) return;
  float r[4 * C4];
#pragma unroll
  for (int k = 0; k < 4 * C4; ++k) r[k] = 0.0f;
  const float* xq = xp + l0 * xs;
  const float4* wl = wrow + g0;
#pragma unroll 2
  for (int l = 0; l < ncols; ++l) {
    const float xl = xq[l * xs];
#pragma unroll
    for (int k = 0; k < C4; ++k) {
      const float4 w4 = wl[l * nfp4 + k];
      r[4 * k] = fmaf(w4.x, xl, r[4 * k]);
      r[4 * k + 1] = fmaf(w4.y, xl, r[4 * k + 1]);
      r[4 * k + 2] = fmaf(w4.z, xl, r[4 * k + 2]);
      r[4 * k + 3] = fmaf(w4.w, xl, r[4 * k + 3]);
    }
  }
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
#pragma unroll
  for (int k = 0; k < C4; ++k) {
    d0 = fmaf(a[4 * k], r[4 * k], d0);
    d1 = fmaf(a[4 * k + 1], r[4 * k + 1], d1);
    d2 = fmaf(a[4 * k + 2], r[4 * k + 2], d2);
    d3 = fmaf(a[4 * k + 3], r[4 * k + 3], d3);
  }
  dot += (d0 + d1) + (d2 + d3);
}

// G = false: the shared form (populations, and ABS beyond one chunk, in
// shared memory). G = true: the global form (the populations in scratch
// [NE][cp], ABS transposed [NFP][cp]; lc == 0 reads W' without staging).
template <bool G>
__global__ void __launch_bounds__(FOLD_THREADS, 2) a2e_all_sizes_kernel(
    const float4* __restrict__ w_fold,   // [S, NE, NE, NFP/4]
    const float* __restrict__ tdown,     // [S, NE]
    const float* __restrict__ ea,        // [S, NF, NE]
    const float* __restrict__ absorbed,  // [C, NF]; G: [NFP][cp]
    const float* __restrict__ align,     // [S, C] or nullptr
    float* __restrict__ tot,             // [C, NF]
    float* __restrict__ ptot,            // [C, NF] or nullptr
    int nsize, int nf, int ne, int ncells, int lc,
    float* __restrict__ scratch,         // G: [NE][cp]; else nullptr
    int64_t cp) {
  using I = typename std::conditional<G, int64_t, int>::type;
  extern __shared__ float4 smem4[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t c = (int64_t)blockIdx.x * T + tid;
  const bool valid = c < ncells;
  const int nfp4 = (nf + 3) / 4;
  const int nch = (nfp4 + FOLD_C4 - 1) / FOLD_C4;
  const bool multi = nch > 1;
  const bool staged = !G || lc > 0;
  const int run = staged ? lc : max(ne - 2, 1);   // columns a unit
  const int stage = (run + 1) * nfp4;
  float4* bufs = smem4;                                   // 2 x [lc+1][nfp4]
  float* xp;        // this cell's x_0; x_l at xp[l * xs]
  const float* ap;  // with multi, this cell's ABS[0]; ABS[f] at ap[f * xs]
  I xs;
  float a[FOLD_CH];
  if constexpr (G) {
    xp = scratch + c;
    ap = absorbed + c;
    xs = cp;
#pragma unroll
    for (int k = 0; k < FOLD_CH; ++k)
      a[k] = (!multi && valid && k < nf) ? absorbed[k * cp + c] : 0.0f;
  } else {
    float* s_x = reinterpret_cast<float*>(smem4 + 2 * stage);  // [ne][T]
    float* s_abs = s_x + ne * T;           // [4 nfp4][T], only when multi
    xp = s_x + tid;
    ap = s_abs + tid;
    xs = T;
#pragma unroll
    for (int k = 0; k < FOLD_CH; ++k)
      a[k] = (!multi && valid && k < nf) ? absorbed[c * nf + k] : 0.0f;
    if (multi)
      for (int f = 0; f < 4 * nfp4; ++f)
        s_abs[f * T + tid] = (valid && f < nf) ? absorbed[c * nf + f] : 0.0f;
  }
  for (int l = 0; l < ne; ++l) xp[l * xs] = (l == 0) ? 1.0e-20f : 0.0f;

  float q = 0.0f;    // sum_{l<j} S[NE-1, l] x_l
  float dot = 0.0f;  // row j's sum_f ABS[f] r[f] over the units so far
  Unit t = {0, 1, 0};
  if (staged) stage_unit(bufs, w_fold, t, ne, nfp4, run, tid, T);
  for (int it = 0; t.s < nsize; ++it) {
    const Unit nx = next_unit(t, ne, run);
    const float4* wrow;
    const float4* wbot;
    if (staged) {
      cp_async_wait_all();
      __syncthreads();  // unit t staged; every thread done with unit it-1
      if (nx.s < nsize)
        stage_unit(bufs + ((it + 1) & 1) * stage, w_fold, nx, ne, nfp4, run,
                   tid, T);
      wrow = bufs + (it & 1) * stage;
      wbot = wrow + run * nfp4;
    } else {
      const float4* W = w_fold + (int64_t)t.s * ne * ne * nfp4;
      wrow = W + ((int64_t)t.j * ne + t.u * run) * nfp4;
      wbot = W + ((int64_t)(ne - 1) * ne + (t.j - 1)) * nfp4;
    }
    const int ncols = unit_cols(t, ne, run);
    const bool bottom = t.u == 0;
    float bot = 0.0f;
    for (int k = 0; k < nch; ++k) {
      const int g0 = k * nfp4 / nch;
      switch ((k + 1) * nfp4 / nch - g0) {
#define A2E_CHUNK(C4)                                                    \
  case C4:                                                               \
    chunk_unit<C4>(wrow, wbot, nfp4, g0, xp, xs, t.u * run, ncols,       \
                   bottom, multi, ap, a, dot, bot);                      \
    break;
        A2E_CHUNK(1) A2E_CHUNK(2) A2E_CHUNK(3) A2E_CHUNK(4)
        A2E_CHUNK(5) A2E_CHUNK(6) A2E_CHUNK(7) A2E_CHUNK(8)
        A2E_CHUNK(9) A2E_CHUNK(10) A2E_CHUNK(11) A2E_CHUNK(12)
#undef A2E_CHUNK
      }
    }
    if (bottom) q = fmaf(bot, xp[(t.j - 1) * xs], q);
    if (last_unit_of_row(t, ne, run)) {
      const int j = t.j;
      const float sj = j < ne - 1 ? dot - q : q;
      dot = 0.0f;
      const float td = tdown[(int64_t)t.s * ne + j];
      float xj = fminf(fmaxf(sj / (td + 1.0e-30f), 0.0f), 3.0e37f);
      if (xj > 1.0e20f) {
        for (int l = 0; l < j; ++l) xp[l * xs] *= 1.0e-20f;
        q *= 1.0e-20f;
        xj *= 1.0e-20f;
      }
      xp[j * xs] = xj;
      if (j == ne - 1) {
        emit_size(xp, xs, c, valid, t.s, ea, align, tot, ptot, nf, ne,
                  ncells);
        for (int l = 0; l < ne; ++l) xp[l * xs] = (l == 0) ? 1.0e-20f : 0.0f;
        q = 0.0f;
      }
    }
    t = nx;
  }
}

constexpr int CLAMP_ROWS = 8;   // rows u of a column formed a pass

// A unit of a2e_clamp's stream of staged weights: size s, column j, part
// k: rows [j + 1 + k lr, min(j + 1 + (k + 1) lr, NE)) of column j.
struct CUnit {
  int s, j, k;
};

__device__ __forceinline__ int cunit_row0(CUnit t, int lr) {
  return t.j + 1 + t.k * lr;
}

__device__ __forceinline__ bool last_cunit_of_col(CUnit t, int ne, int lr) {
  return cunit_row0(t, lr) + lr >= ne;
}

__device__ __forceinline__ CUnit next_cunit(CUnit t, int ne, int lr) {
  if (!last_cunit_of_col(t, ne, lr)) return {t.s, t.j, t.k + 1};
  if (t.j + 1 < ne - 1) return {t.s, t.j + 1, 0};
  return {t.s + 1, 0, 0};
}

// Queues the copies of unit t's rows of w_unf into buf ([lr][nfp4]
// float4) and commits them as one cp.async group.
__device__ __forceinline__ void stage_cunit(float4* buf,
                                            const float4* __restrict__ w,
                                            CUnit t, int ne, int nfp4, int lr,
                                            int tid, int T) {
  const int u0 = cunit_row0(t, lr);
  const int n = (min(u0 + lr, ne) - u0) * nfp4;
  const float4* src = w + (((int64_t)t.s * ne + t.j) * ne + u0) * nfp4;
  for (int i = tid; i < n; i += T) cp_async16(buf + i, src + i);
  cp_async_commit();
}

// One register chunk, float4 groups [g0, g0 + C4), of CLAMP_ROWS rows
// (row r at rows[r], staged or in device memory): adds sum_f ABS[f]
// W[u, j, f] into d[r], each row's sum in four independent parts. `a` holds
// the chunk's ABS; with `multi` (more than one chunk) it is loaded here
// from ap[f * xs].
template <int C4, typename I>
__device__ __forceinline__ void chunk_rows(
    const float4* const (&rows)[CLAMP_ROWS], int g0, bool multi,
    const float* ap, I xs, float (&a)[FOLD_CH], float (&d)[CLAMP_ROWS]) {
  if (multi) {
#pragma unroll
    for (int k = 0; k < 4 * C4; ++k) a[k] = ap[(4 * g0 + k) * xs];
  }
#pragma unroll
  for (int r = 0; r < CLAMP_ROWS; ++r) {
    float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, e3 = 0.0f;
#pragma unroll
    for (int k = 0; k < C4; ++k) {
      const float4 w4 = rows[r][g0 + k];
      e0 = fmaf(a[4 * k], w4.x, e0);
      e1 = fmaf(a[4 * k + 1], w4.y, e1);
      e2 = fmaf(a[4 * k + 2], w4.z, e2);
      e3 = fmaf(a[4 * k + 3], w4.w, e3);
    }
    d[r] += (e0 + e1) + (e2 + e3);
  }
}

// x_j = clip(s_j / (tdown_j + 1e-30), 0, 3e37) with the 1e-20 rescale of
// every other slot (x_l for l < j, p[u] for u > j); stores it in slot j.
template <typename I>
__device__ __forceinline__ float set_population(float* slot, I xs, int ne,
                                                int j, float sj, float td) {
  float xj = fminf(fmaxf(sj / (td + 1.0e-30f), 0.0f), 3.0e37f);
  if (xj > 1.0e20f) {
    for (int l = 0; l < ne; ++l)
      if (l != j) slot[l * xs] *= 1.0e-20f;
    xj *= 1.0e-20f;
  }
  slot[j * xs] = xj;
  return xj;
}

// G as for a2e_all_sizes_kernel: the slots in scratch [NE][cp], ABS
// transposed [NFP][cp]; lr == 0 reads W without staging. The global form
// asks for two blocks an SM, not three: its 64-bit strides spill at 170
// registers.
template <bool G>
__global__ void __launch_bounds__(FOLD_THREADS, G ? 2 : 3) a2e_clamp_kernel(
    const float4* __restrict__ w_unf,    // [S, NE (l), NE (u), NFP/4]
    const float* __restrict__ tdown,     // [S, NE]
    const float* __restrict__ ea,        // [S, NF, NE]
    const float* __restrict__ absorbed,  // [C, NF]; G: [NFP][cp]
    const float* __restrict__ align,     // [S, C] or nullptr
    float* __restrict__ tot,             // [C, NF]
    float* __restrict__ ptot,            // [C, NF] or nullptr
    int nsize, int nf, int ne, int ncells, int lr,
    float* __restrict__ scratch,         // G: [NE][cp]; else nullptr
    int64_t cp) {
  using I = typename std::conditional<G, int64_t, int>::type;
  extern __shared__ float4 smem4[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t c = (int64_t)blockIdx.x * T + tid;
  const bool valid = c < ncells;
  const int nfp4 = (nf + 3) / 4;
  const int nch = (nfp4 + FOLD_C4 - 1) / FOLD_C4;
  const bool multi = nch > 1;
  const bool staged = !G || lr > 0;
  const int run = staged ? lr : ne - 1;   // rows a unit
  const int stage = run * nfp4;
  float4* bufs = smem4;                                   // 2 x [lr][nfp4]
  float* slot;      // this cell's slot 0; slot u at slot[u * xs]
  const float* ap;  // with multi, this cell's ABS[0]; ABS[f] at ap[f * xs]
  I xs;
  float a[FOLD_CH];
  if constexpr (G) {
    slot = scratch + c;
    ap = absorbed + c;
    xs = cp;
#pragma unroll
    for (int k = 0; k < FOLD_CH; ++k)
      a[k] = (!multi && valid && k < nf) ? absorbed[k * cp + c] : 0.0f;
  } else {
    float* s_slot = reinterpret_cast<float*>(smem4 + 2 * stage);  // [ne][T]
    float* s_abs = s_slot + ne * T;        // [4 nfp4][T], only when multi
    slot = s_slot + tid;
    ap = s_abs + tid;
    xs = T;
#pragma unroll
    for (int k = 0; k < FOLD_CH; ++k)
      a[k] = (!multi && valid && k < nf) ? absorbed[c * nf + k] : 0.0f;
    if (multi)
      for (int f = 0; f < 4 * nfp4; ++f)
        s_abs[f * T + tid] = (valid && f < nf) ? absorbed[c * nf + f] : 0.0f;
  }
  for (int l = 0; l < ne; ++l) slot[l * xs] = (l == 0) ? 1.0e-20f : 0.0f;

  float xj = 1.0e-20f;  // the population of the column being formed
  float sacc = 0.0f;    // s_{j+1}: sum of the new p[u], j < u <= NE-2
  CUnit t = {0, 0, 0};
  if (staged) stage_cunit(bufs, w_unf, t, ne, nfp4, run, tid, T);
  for (int it = 0; t.s < nsize; ++it) {
    const CUnit nx = next_cunit(t, ne, run);
    const int u0 = cunit_row0(t, run);
    const float4* buf;
    if (staged) {
      cp_async_wait_all();
      __syncthreads();  // unit t staged; every thread done with unit it-1
      if (nx.s < nsize)
        stage_cunit(bufs + ((it + 1) & 1) * stage, w_unf, nx, ne, nfp4, run,
                    tid, T);
      buf = bufs + (it & 1) * stage;
    } else {
      buf = w_unf + (((int64_t)t.s * ne + t.j) * ne + u0) * nfp4;
    }
    const float* td = tdown + (int64_t)t.s * ne;
    if (t.k == 0 && t.j > 0) {
      xj = set_population(slot, xs, ne, t.j, sacc, td[t.j]);
      sacc = 0.0f;
    }
    const int nrows = min(u0 + run, ne) - u0;
    for (int i = 0; i < nrows; i += CLAMP_ROWS) {
      // a short last pass re-reads its last row and drops the sum
      const float4* rows[CLAMP_ROWS];
      float d[CLAMP_ROWS];
#pragma unroll
      for (int r = 0; r < CLAMP_ROWS; ++r) {
        rows[r] = buf + min(i + r, nrows - 1) * nfp4;
        d[r] = 0.0f;
      }
      for (int k = 0; k < nch; ++k) {
        const int g0 = k * nfp4 / nch;
        switch ((k + 1) * nfp4 / nch - g0) {
#define A2E_ROWS(C4)                                  \
  case C4:                                            \
    chunk_rows<C4>(rows, g0, multi, ap, xs, a, d);    \
    break;
          A2E_ROWS(1) A2E_ROWS(2) A2E_ROWS(3) A2E_ROWS(4)
          A2E_ROWS(5) A2E_ROWS(6) A2E_ROWS(7) A2E_ROWS(8)
          A2E_ROWS(9) A2E_ROWS(10) A2E_ROWS(11) A2E_ROWS(12)
#undef A2E_ROWS
        }
      }
#pragma unroll
      for (int r = 0; r < CLAMP_ROWS; ++r) {
        const int u = u0 + i + r;
        if (i + r < nrows) {
          const float p = fmaf(fmaxf(d[r], 0.0f), xj, slot[u * xs]);
          slot[u * xs] = p;
          if (u <= ne - 2) sacc += p;
        }
      }
    }
    if (t.j == ne - 2 && last_cunit_of_col(t, ne, run)) {
      // the last step: x_{NE-1} from row NE-1 alone, then the emission
      set_population(slot, xs, ne, ne - 1, slot[(ne - 1) * xs], td[ne - 1]);
      emit_size(slot, xs, c, valid, t.s, ea, align, tot, ptot, nf, ne,
                ncells);
      for (int l = 0; l < ne; ++l) slot[l * xs] = (l == 0) ? 1.0e-20f : 0.0f;
      xj = 1.0e-20f;
      sacc = 0.0f;
    }
    t = nx;
  }
}

// Blocks of `kernel` that fit on one SM of the current device with `smem`
// bytes of dynamic shared memory and `threads` a block, by its registers
// and shared memory; negative: a CUDA error.
template <typename K>
int blocks_per_sm(K kernel, size_t smem, int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of a2e_all_sizes with `tile` cells a
// block and runs of `lc` columns: two staging buffers [lc + 1][NFP], x
// [NE][tile], and ABS [NFP][tile] when NFREQ needs more than one chunk.
size_t a2e_fold_smem_bytes(int nf, int ne, int tile, int lc) {
  const size_t nfp4 = (nf + 3) / 4;
  const bool multi = nfp4 > (size_t)FOLD_C4;
  return sizeof(float4) * 2 * (size_t)(lc + 1) * nfp4 +
         sizeof(float) * ((size_t)ne * tile + (multi ? 4 * nfp4 * tile : 0));
}

// Blocks of a2e_all_sizes that fit on one SM of the current device at
// (tile, lc), by its registers and shared memory; negative: a CUDA error.
int a2e_fold_blocks_per_sm(int nf, int ne, int tile, int lc) {
  return blocks_per_sm(a2e_all_sizes_kernel<false>,
                       a2e_fold_smem_bytes(nf, ne, tile, lc), tile);
}

// The global form's dynamic shared memory, in bytes: the two staging
// buffers [lc + 1][NFP] alone, none when lc == 0 (W' read unstaged).
size_t a2e_fold_global_smem_bytes(int nf, int lc) {
  const size_t nfp4 = (nf + 3) / 4;
  return lc > 0 ? sizeof(float4) * 2 * (size_t)(lc + 1) * nfp4 : 0;
}

// Blocks of the global form of a2e_all_sizes on one SM at (tile, lc).
int a2e_fold_global_blocks_per_sm(int nf, int ne, int tile, int lc) {
  return blocks_per_sm(a2e_all_sizes_kernel<true>,
                       a2e_fold_global_smem_bytes(nf, lc), tile);
}

// Dynamic shared memory, in bytes, of a2e_clamp with `tile` cells a block
// and runs of `lr` rows: two staging buffers [lr][NFP], the slots [NE]
// [tile], and ABS [NFP][tile] when NFREQ needs more than one chunk.
size_t a2e_clamp_smem_bytes(int nf, int ne, int tile, int lr) {
  const size_t nfp4 = (nf + 3) / 4;
  const bool multi = nfp4 > (size_t)FOLD_C4;
  return sizeof(float4) * 2 * (size_t)lr * nfp4 +
         sizeof(float) * ((size_t)ne * tile + (multi ? 4 * nfp4 * tile : 0));
}

// Blocks of a2e_clamp that fit on one SM of the current device at
// (tile, lr); negative: a CUDA error.
int a2e_clamp_blocks_per_sm(int nf, int ne, int tile, int lr) {
  return blocks_per_sm(a2e_clamp_kernel<false>,
                       a2e_clamp_smem_bytes(nf, ne, tile, lr), tile);
}

// The global form's dynamic shared memory, in bytes: the two staging
// buffers [lr][NFP] alone, none when lr == 0 (W read unstaged).
size_t a2e_clamp_global_smem_bytes(int nf, int lr) {
  const size_t nfp4 = (nf + 3) / 4;
  return sizeof(float4) * 2 * (size_t)lr * nfp4;
}

// Blocks of the global form of a2e_clamp on one SM at (tile, lr).
int a2e_clamp_global_blocks_per_sm(int nf, int ne, int tile, int lr) {
  return blocks_per_sm(a2e_clamp_kernel<true>,
                       a2e_clamp_global_smem_bytes(nf, lr), tile);
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
// w_fold [S, NE, NE, NFP] (NFP = 4 ceil(NFREQ/4)), 16-byte aligned.
int a2e_all_sizes(const float* w_fold, const float* tdown, const float* ea,
                  const float* absorbed, const float* align, float* tot,
                  float* ptot, int nsize, int nf, int ne, int ncells,
                  int tile, int lc, void* stream) {
  const size_t smem = a2e_fold_smem_bytes(nf, ne, tile, lc);
  cudaError_t err = cudaFuncSetAttribute(
      a2e_all_sizes_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (ncells + tile - 1) / tile;
  a2e_all_sizes_kernel<false><<<blocks, tile, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(w_fold), tdown, ea, absorbed, align,
      tot, ptot, nsize, nf, ne, ncells, lc, nullptr, 0);
  return (int)cudaGetLastError();
}

// The global form: the arguments of a2e_all_sizes with abs_t, ABS
// transposed and zero-padded [NFP][cp], in place of absorbed, the scratch
// [NE][cp] for the populations, and cp = the cells rounded up to a
// multiple of tile; lc == 0 reads W' unstaged.
int a2e_all_sizes_global(const float* w_fold, const float* tdown,
                         const float* ea, const float* abs_t,
                         const float* align, float* tot, float* ptot,
                         float* scratch, int nsize, int nf, int ne,
                         int ncells, long long cp, int tile, int lc,
                         void* stream) {
  const size_t smem = a2e_fold_global_smem_bytes(nf, lc);
  cudaError_t err = cudaFuncSetAttribute(
      a2e_all_sizes_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  a2e_all_sizes_kernel<true><<<(int)(cp / tile), tile, smem,
                                (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(w_fold), tdown, ea, abs_t, align, tot,
      ptot, nsize, nf, ne, ncells, lc, scratch, (int64_t)cp);
  return (int)cudaGetLastError();
}

// The exact (clamp) solve; the arguments of a2e_all_sizes with w_unf
// [S, NE, NE, NFP] (column, row, frequency) in place of w_fold and runs of
// `lr` rows in place of lc.
int a2e_clamp(const float* w_unf, const float* tdown, const float* ea,
              const float* absorbed, const float* align, float* tot,
              float* ptot, int nsize, int nf, int ne, int ncells, int tile,
              int lr, void* stream) {
  const size_t smem = a2e_clamp_smem_bytes(nf, ne, tile, lr);
  cudaError_t err = cudaFuncSetAttribute(
      a2e_clamp_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (ncells + tile - 1) / tile;
  a2e_clamp_kernel<false><<<blocks, tile, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(w_unf), tdown, ea, absorbed, align,
      tot, ptot, nsize, nf, ne, ncells, lr, nullptr, 0);
  return (int)cudaGetLastError();
}

// The clamp kernel's global form; the arguments of a2e_all_sizes_global
// with w_unf in place of w_fold and runs of `lr` rows (0: unstaged).
int a2e_clamp_global(const float* w_unf, const float* tdown, const float* ea,
                     const float* abs_t, const float* align, float* tot,
                     float* ptot, float* scratch, int nsize, int nf, int ne,
                     int ncells, long long cp, int tile, int lr,
                     void* stream) {
  const size_t smem = a2e_clamp_global_smem_bytes(nf, lr);
  cudaError_t err = cudaFuncSetAttribute(
      a2e_clamp_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  a2e_clamp_kernel<true><<<(int)(cp / tile), tile, smem,
                            (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(w_unf), tdown, ea, abs_t, align, tot,
      ptot, nsize, nf, ne, ncells, lr, scratch, (int64_t)cp);
  return (int)cudaGetLastError();
}

const char* a2e_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
