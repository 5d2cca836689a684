// The index rules the gather/scatter probes share (csrc/probe_gather.cu,
// csrc/probe_scatter.cu): the probes' LCG, a floored modulus without a
// division, and a lane's walk through its indices; and the device queries
// every probe source uses (csrc/probe_onehot.cu too).
//
//   ADD        k_i = (ix mod M + i) mod M
//   LCG_BEFORE j = lcg(j, i, M); k_i = j, j_0 = ix
//   LCG_AFTER  k_i = j; then j = lcg(j, i, M)
// with lcg(j, i, M) = ((j * 1103515245 + 12345 + i) wrapped to int32)
// floored-mod M, as the probes compute it with JAX's int32 arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace probe {

enum { ADD = 0, LCG_BEFORE = 1, LCG_AFTER = 2 };

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
// ADD steps with a compare and reset, so no step divides.
template <int RULE>
struct Walk {
  int j;
  FloorMod fm;

  __device__ __forceinline__ Walk(int ix, const FloorMod& f) : fm(f) {
    j = RULE == ADD ? f(ix) : ix;
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

// Largest dynamic shared memory a block may use on `device` (the current
// device by default), in bytes, or -1.
inline int max_smem(int device = -1) {
  int v = 0;
  if (device < 0 && cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Lets `kern` take `smem` bytes of dynamic shared memory (needed above
// 48 KB); returns a cudaError_t.
template <class K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Streaming multiprocessors of `device` (the current device by default),
// or -1.
inline int sm_count(int device = -1) {
  int sms = 0;
  if (device < 0 && cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return -1;
  return sms;
}

}  // namespace probe
