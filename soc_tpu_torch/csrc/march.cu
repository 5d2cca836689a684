// The transport's march block for Hopper (sm_90a): one launch runs what
// transport/propagate.py PoolRun._marches runs eagerly, for a pool on a
// root grid.
//
// Replaces: no TPU kernel. soc_tpu's march is plain JAX inside a
// lax.while_loop, which XLA fuses on the TPU; the port ran it as PyTorch
// elementwise kernels, about 1,300 a block (a service with a 13-round
// Threefry of int64 words, then REFILL_PERIOD march steps of about 70
// kernels each), each streaming 2M-lane arrays through device memory.
//
// What it computes, for each lane of the pool (march_block_kernel):
//   `services` times: the service (StepKit.service: the step's Threefry
//   words, the phase-function inverse-CDF lookup, _deflect, -log(u_fp),
//   the counter increment) for a lane frozen at a scattering point, then
//   `period` march steps (StepKit.march on the root grid: boundary_step,
//   the deposit with its Taylor form below TAULIM, the attenuation, the
//   scattering point, the root index after the crossing, the failed-step
//   nudge, the exits, MAX_SCATTERINGS and PHOTON_LIMIT). A lane that
//   freezes at a scattering point or dies stops there, as in the eager
//   block: a frozen lane waits for the next service.
// Deposits go by atomicAdd into tabs (or, with ALI, into xab for the
// packet's own emitting cell) and into the per-frequency tally intf at
// cell * ncol + channel (the channel less col0, clamped into the block,
// under a tally block); a lane that is not active adds nothing. The
// deposits' sum (absd) is summed in the block and added once a block.
//
// What bounds it: device memory. A lane's state (pos, dir, ind, photons,
// ifreq, stream, hi, counter, scatterings, e_cell, pending, free_path,
// tau, esc_pending) is read once, 97 bytes, and what the block changes
// written once, 65 bytes; in between it stays in registers. The density
// and the per-frequency constants (kabs, ksca, tw, the csc table) are
// read through the read-only cache; the tallies' atomics land in L2
// (64^3 cells x 44 channels: 46 MB).
//
// The arithmetic is the eager block's, operation by operation and in its
// order: each product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, so nvcc contracts none into
// an FMA), and expf, logf, sinf and cosf are the same library functions
// PyTorch's kernels call. A lane's path is then the eager block's bit for
// bit; only the tallies' sums differ, by the order of the atomics.
// Constants are written as double literals cast to float, as PyTorch casts
// a Python float to a float32 tensor's type.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PARITY = 0x1BD11BDAu;          // rng._PARITY
constexpr int MAX_SCATTERINGS = 20;                // constants.MAX_SCATTERINGS
constexpr float PEPS = static_cast<float>(1.0e-4);       // constants.PEPS
constexpr float TWO_PEPS = static_cast<float>(2.0 * 1.0e-4);  // 2.0 * PEPS
constexpr float DEPS = static_cast<float>(5.0e-5);       // constants.DEPS
constexpr float TAULIM = static_cast<float>(5.0e-4);     // constants.TAULIM
constexpr float PHOTON_LIMIT = static_cast<float>(1.0e-30);
constexpr float EPS_SCALE = static_cast<float>(4.76837158203125e-07);  // 2^-21
constexpr float TWO_PI = static_cast<float>(2.0 * 3.141592653589793);
constexpr float UNIT_MIN = static_cast<float>(1e-12);    // rng._bits_to_unit
constexpr float KD_MIN = static_cast<float>(1e-30);      // clamp of ksca * dens
constexpr float HELPER_X = static_cast<float>(0.9);      // _deflect's helper
constexpr float INV_2_32 = static_cast<float>(1.0 / 4294967296.0);
constexpr float INV_2_16 = static_cast<float>(1.0 / 65536.0);

struct Lanes {
  // the pool's state as the block finds it
  const float* pos;            // [N, 3]
  const float* dir;            // [N, 3]
  const long long* ind;        // -1 dead
  const float* photons;
  const long long* ifreq;
  const long long* stream;     // uint32 words held in int64
  const long long* hi;
  const long long* counter;
  const long long* scat;
  const long long* e_cell;     // -1 for packets of other sources
  const unsigned char* pending;
  const float* free_path;
  const float* tau;
  const float* esc;
  // the state it leaves (ifreq, stream, hi and e_cell do not change)
  float* pos_o;
  float* dir_o;
  long long* ind_o;
  float* photons_o;
  long long* counter_o;
  long long* scat_o;
  unsigned char* pending_o;
  float* free_path_o;
  float* tau_o;
  float* esc_o;
  // the grid, the per-frequency constants and the tallies
  const float* dens;           // [cells]
  const float* kabs;           // [NFREQ]
  const float* ksca;
  const float* tw;
  const float* csc;            // [NFREQ, bins]
  float* tabs;                 // [cells]
  float* intf;                 // [cells * ncol], or null: no such tally
  float* xab;                  // [cells], or null: no ALI
  float* absd;                 // () the deposits' sum
  long long n;
  long long cells;
  int nx, ny, nz;
  int bins, ncol, col0, block;
  int services, period;
  uint32_t seed;
};

// torch's clamp_min / amin / amax on float: a NaN passes through
__device__ __forceinline__ float max_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float max2_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.remainder(x, 1.0): fmod, moved into [0, 1) when negative
__device__ __forceinline__ float frac1(float x) {
  float m = fmodf(x, 1.0f);
  return (m != 0.0f && m < 0.0f) ? add_rn(m, 1.0f) : m;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// rng.threefry2x32 at 13 rounds: four rounds a key injection, the last
// block one round
__device__ __forceinline__ void threefry13(uint32_t k0, uint32_t k1,
                                           uint32_t c0, uint32_t c1,
                                           uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define TF_ROUND(d) x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17)
  x0 += k1; x1 += k2 + 4u;
#undef TF_ROUND
  o0 = x0;
  o1 = x1;
}

// rng.step_uniforms' words: stream (seed, hi, stream), slot 2 * counter
__device__ __forceinline__ void step_words(uint32_t seed, long long hi,
                                           long long stream,
                                           long long counter, uint32_t& b0,
                                           uint32_t& b1) {
  threefry13(seed, static_cast<uint32_t>(hi), static_cast<uint32_t>(stream),
             static_cast<uint32_t>(counter) * 2u, b0, b1);
}

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(add_rn(add_rn(mul_rn(a, a), mul_rn(b, b)), mul_rn(c, c)));
}

// _cross(a, b) component formulas, each product rounded
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = sub_rn(mul_rn(a[1], b[2]), mul_rn(a[2], b[1]));
  o[1] = sub_rn(mul_rn(a[2], b[0]), mul_rn(a[0], b[2]));
  o[2] = sub_rn(mul_rn(a[0], b[1]), mul_rn(a[1], b[0]));
}

// StepKit.service for one frozen lane: the new direction and free path
__device__ void serve(const Lanes& L, long long ifreq, long long stream,
                      long long hi, long long counter, float* d, float& fp) {
  uint32_t b0, b1;
  step_words(L.seed, hi, stream, counter, b0, b1);
  const float u_fp = max_nan(mul_rn(__uint2float_rn(b0), INV_2_32), UNIT_MIN);
  const float u_bin = mul_rn(__uint2float_rn(b1 >> 16), INV_2_16);
  const float u_phi = mul_rn(__uint2float_rn(b1 & 0xFFFFu), INV_2_16);
  long long bin =
      static_cast<long long>(mul_rn(u_bin, static_cast<float>(L.bins)));
  bin = bin < 0 ? 0 : (bin > L.bins - 1 ? L.bins - 1 : bin);
  const float ct = __ldg(L.csc + ifreq * L.bins + bin);
  // _deflect(dir, ct, 2 pi u_phi)
  const float phi = mul_rn(u_phi, TWO_PI);
  const float st = __fsqrt_rn(max_nan(sub_rn(1.0f, mul_rn(ct, ct)), 0.0f));
  const float hx = fabsf(d[0]) < HELPER_X ? 1.0f : 0.0f;
  const float helper[3] = {hx, sub_rn(1.0f, hx), 0.0f};
  float t1[3], t2[3];
  cross3(d, helper, t1);
  const float n1 = norm3(t1[0], t1[1], t1[2]);
  for (int k = 0; k < 3; ++k) t1[k] = div_rn(t1[k], n1);
  cross3(d, t1, t2);
  const float sc = mul_rn(st, cosf(phi));
  const float ss = mul_rn(st, sinf(phi));
  float nd[3];
  for (int k = 0; k < 3; ++k) {
    const float v = add_rn(add_rn(mul_rn(ct, d[k]), mul_rn(sc, t1[k])),
                           mul_rn(ss, t2[k]));
    nd[k] = fabsf(v) < DEPS ? DEPS : v;
  }
  const float n2 = norm3(nd[0], nd[1], nd[2]);
  for (int k = 0; k < 3; ++k) d[k] = div_rn(nd[k], n2);
  fp = -logf(u_fp);
}

__global__ void __launch_bounds__(THREADS) march_block_kernel(const Lanes L) {
  __shared__ float warp_sum[THREADS / 32];
  const long long i = static_cast<long long>(blockIdx.x) * THREADS
                      + threadIdx.x;
  float absd = 0.0f;
  if (i < L.n) {
    float p[3], d[3];
    for (int k = 0; k < 3; ++k) {
      p[k] = L.pos[3 * i + k];
      d[k] = L.dir[3 * i + k];
    }
    long long ind = L.ind[i];
    float photons = L.photons[i];
    const long long ifreq = L.ifreq[i];
    const long long stream = L.stream[i];
    const long long hi = L.hi[i];
    long long counter = L.counter[i];
    long long scat = L.scat[i];
    const long long e_cell = L.e_cell[i];
    bool pending = L.pending[i] != 0;
    float fp = L.free_path[i];
    float tau = L.tau[i];
    float esc = L.esc[i];
    float kabs = 0.0f, ksca = 0.0f, tw = 0.0f;
    long long col = 0;
    if (ind >= 0) {
      kabs = __ldg(L.kabs + ifreq);
      ksca = __ldg(L.ksca + ifreq);
      tw = __ldg(L.tw + ifreq);
      col = ifreq;
      if (L.block) {
        col -= L.col0;
        col = col < 0 ? 0 : (col > L.ncol - 1 ? L.ncol - 1 : col);
      }
    }
    const float fnx = static_cast<float>(L.nx);
    const float fny = static_cast<float>(L.ny);
    const float fnz = static_cast<float>(L.nz);
    for (int s = 0; s < L.services; ++s) {
      if (pending && ind >= 0) {
        serve(L, ifreq, stream, hi, counter, d, fp);
        counter += 1;
        tau = 0.0f;
        pending = false;
      }
      for (int step = 0; step < L.period; ++step) {
        if (ind < 0 || pending) break;
        long long g = ind < L.cells ? ind : L.cells - 1;
        const float dens = __ldg(L.dens + g);
        // traverse.boundary_step
        float ds = 0.0f;
        for (int k = 0; k < 3; ++k) {
          const float fr = frac1(p[k]);
          const float eps = max_nan(mul_rn(fabsf(p[k]), EPS_SCALE), PEPS);
          const float pos_step = div_rn(sub_rn(add_rn(1.0f, eps), fr), d[k]);
          const float neg_step = div_rn(sub_rn(-eps, fr), d[k]);
          const float sk = d[k] > 0.0f ? pos_step : neg_step;
          ds = k == 0 ? sk : min_nan(ds, sk);
        }
        float pb[3];
        for (int k = 0; k < 3; ++k) pb[k] = add_rn(p[k], mul_rn(ds, d[k]));
        // the level is 0 on a root grid: ds_gl = ds * exp2(-0) = ds
        const float dsd = mul_rn(ds, dens);
        const float tau_abs_full = mul_rn(dsd, kabs);
        const float dtau_sca = mul_rn(dsd, ksca);
        const bool scatter_now = fp < add_rn(tau, dtau_sca);
        const float dx_gl = div_rn(sub_rn(fp, tau),
                                max_nan(mul_rn(ksca, dens), KD_MIN));
        const float tau_abs_part = mul_rn(mul_rn(dx_gl, dens), kabs);
        const float dx_local = max_nan(sub_rn(dx_gl, TWO_PEPS), 0.0f);
        // the deposit
        const float tau_abs = scatter_now ? tau_abs_part : tau_abs_full;
        const float att = expf(-tau_abs);
        const float delta = tau_abs > TAULIM
            ? mul_rn(photons, sub_rn(1.0f, att))
            : mul_rn(mul_rn(photons, tau_abs),
                     sub_rn(1.0f, mul_rn(0.5f, tau_abs)));
        const float wdep = mul_rn(delta, tw);     // times ADHOC = 1.0
        if (L.xab != nullptr && g == e_cell) {
          atomicAdd(L.xab + g, wdep);
        } else {
          atomicAdd(L.tabs + g, wdep);
        }
        if (L.intf != nullptr) {
          atomicAdd(L.intf + g * L.ncol + col, delta);
        }
        absd = add_rn(absd, delta);
        photons = mul_rn(photons, att);
        bool exited = false;
        if (scatter_now) {
          // freeze at the scattering point
          for (int k = 0; k < 3; ++k)
            p[k] = add_rn(p[k], mul_rn(dx_local, d[k]));
        } else {
          // cross into the next root cell (index_update_stack, level 0)
          const bool outside = pb[0] <= 0.0f || pb[0] >= fnx
                               || pb[1] <= 0.0f || pb[1] >= fny
                               || pb[2] <= 0.0f || pb[2] >= fnz;
          const long long nind = outside ? -1LL
              : static_cast<long long>(floorf(pb[2])) * L.nx * L.ny
                + static_cast<long long>(floorf(pb[1])) * L.nx
                + static_cast<long long>(floorf(pb[0]));
          if (nind == ind) {
            // traverse.failed_step_nudge
            const float m = max2_nan(max2_nan(fabsf(pb[0]), fabsf(pb[1])),
                                     fabsf(pb[2]));
            const float sn = max_nan(mul_rn(m, EPS_SCALE), PEPS);
            for (int k = 0; k < 3; ++k) pb[k] = add_rn(pb[k], mul_rn(sn, d[k]));
          }
          for (int k = 0; k < 3; ++k) p[k] = pb[k];
          ind = nind;
          exited = nind < 0;
        }
        if (scatter_now) scat += 1;
        const bool over = scatter_now && scat > MAX_SCATTERINGS;
        const bool exhausted = fabsf(photons) < PHOTON_LIMIT;
        if (exited || over) esc = add_rn(esc, photons);
        if (over || exhausted) ind = -1;
        tau = scatter_now ? 0.0f : add_rn(tau, dtau_sca);
        pending = scatter_now && ind >= 0;
      }
    }
    pending = pending && ind >= 0;
    for (int k = 0; k < 3; ++k) {
      L.pos_o[3 * i + k] = p[k];
      L.dir_o[3 * i + k] = d[k];
    }
    L.ind_o[i] = ind;
    L.photons_o[i] = photons;
    L.counter_o[i] = counter;
    L.scat_o[i] = scat;
    L.pending_o[i] = pending ? 1 : 0;
    L.free_path_o[i] = fp;
    L.tau_o[i] = tau;
    L.esc_o[i] = esc;
  }
  // the block's deposits, one atomic add
  for (int off = 16; off > 0; off >>= 1)
    absd += __shfl_down_sync(0xFFFFFFFFu, absd, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = absd;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
    atomicAdd(L.absd, total);
  }
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

int march_block(const float* pos, const float* dir, const long long* ind,
                const float* photons, const long long* ifreq,
                const long long* stream, const long long* hi,
                const long long* counter, const long long* scat,
                const long long* e_cell, const unsigned char* pending,
                const float* free_path, const float* tau, const float* esc,
                float* pos_o, float* dir_o, long long* ind_o,
                float* photons_o, long long* counter_o, long long* scat_o,
                unsigned char* pending_o, float* free_path_o, float* tau_o,
                float* esc_o, const float* dens, const float* kabs,
                const float* ksca, const float* tw, const float* csc,
                float* tabs, float* intf, float* xab, float* absd,
                long long n, long long cells, int nx, int ny, int nz,
                int bins, int ncol, int col0, int block, int services,
                int period, unsigned int seed, void* stream_handle) {
  if (n <= 0) return 0;
  Lanes L{pos, dir, ind, photons, ifreq, stream, hi, counter, scat, e_cell,
          pending, free_path, tau, esc, pos_o, dir_o, ind_o, photons_o,
          counter_o, scat_o, pending_o, free_path_o, tau_o, esc_o, dens,
          kabs, ksca, tw, csc, tabs, intf, xab, absd, n, cells, nx, ny, nz,
          bins, ncol, col0, block, services, period, seed};
  march_block_kernel<<<blocks_for(n), THREADS, 0,
                       (cudaStream_t)stream_handle>>>(L);
  return static_cast<int>(cudaGetLastError());
}

const char* march_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
