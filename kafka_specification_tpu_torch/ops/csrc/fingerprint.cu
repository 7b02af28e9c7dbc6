// Kernel K1: murmur3 fingerprints of packed state rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel kafka_specification_tpu/ops/pallas_fingerprint.py
// (fingerprint_pallas, body _kernel).  Per row of K u32 lanes it computes
// murmur3_x86_32 twice (seeds 0x9747B28C and 0x3C6EF372), remaps an all-ones
// result pair to lo = 0xFFFFFFFE, and writes the all-ones sentinel pair for
// an invalid row.  Bit-identical to ops/fingerprint.py::hash_pair.
//
// Bound: memory.  Each row reads 4*K bytes of lanes and one valid byte and
// writes 8 bytes, against some 80 integer operations; at K = 3 that is 21
// bytes a row, far below the card's operations-per-byte balance.  Design:
// one thread per row, both hash streams in registers, one pass over the
// rows; consecutive threads read consecutive rows, so a warp's loads cover
// one contiguous span of the lane matrix.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kSeedHi = 0x9747B28Cu;
constexpr uint32_t kSeedLo = 0x3C6EF372u;
constexpr uint32_t kSent = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix_lane(uint32_t h, uint32_t lane) {
  uint32_t k = lane * kC1;
  k = rotl32(k, 15) * kC2;
  h ^= k;
  return rotl32(h, 13) * 5u + 0xE6546B64u;
}

__global__ void fingerprint_kernel(const uint32_t* __restrict__ lanes,
                                   const uint8_t* __restrict__ valid,
                                   uint32_t* __restrict__ hi,
                                   uint32_t* __restrict__ lo,
                                   long long m, int k) {
  long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= m) return;
  if (!valid[row]) {
    hi[row] = kSent;
    lo[row] = kSent;
    return;
  }
  const uint32_t* r = lanes + row * k;
  uint32_t h1 = kSeedHi, h2 = kSeedLo;
  for (int i = 0; i < k; ++i) {
    uint32_t v = r[i];
    h1 = mix_lane(h1, v);
    h2 = mix_lane(h2, v);
  }
  h1 = fmix32(h1 ^ (uint32_t)(4 * k));
  h2 = fmix32(h2 ^ (uint32_t)(4 * k));
  if (h1 == kSent && h2 == kSent) h2 = 0xFFFFFFFEu;
  hi[row] = h1;
  lo[row] = h2;
}

}  // namespace

extern "C" {

const char* kspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// lanes: u32[m, k] row-major; valid: u8[m]; hi, lo: u32[m] outputs.
// Launches on `stream` and returns the launch's CUDA error code.
int kspec_fingerprint(const void* lanes, const void* valid, void* hi, void* lo,
                      long long m, int k, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  fingerprint_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lanes, (const uint8_t*)valid, (uint32_t*)hi,
      (uint32_t*)lo, m, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
