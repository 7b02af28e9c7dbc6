// Kernel K1: murmur3 fingerprints of packed state rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel kafka_specification_tpu/ops/pallas_fingerprint.py:41
// (fingerprint_pallas, body _kernel).  Per row of K u32 lanes it computes
// murmur3_x86_32 twice (seeds 0x9747B28C and 0x3C6EF372), remaps an all-ones
// result pair to lo = 0xFFFFFFFE, and writes the all-ones sentinel pair for
// an invalid row.  Bit-identical to ops/fingerprint.py::hash_pair.
//
// It reads the port's carrier where it lies: int64[M, K] lanes holding u32
// values (the low word is the lane) and a bool[M] mask, and writes int64
// hi and lo holding u32 values, so the wrapper converts nothing around it.
//
// Bound: memory.  Each row reads 8*K bytes of lanes and one valid byte and
// writes 16 bytes, against some 20*K + 22 integer operations; at K = 3 that
// is 41 bytes a row, far below the card's operations-per-byte balance.
// Design: a block takes 256 consecutive rows, whose lanes are one
// contiguous span of 256*K words; its threads stage that span in shared
// memory with 16-byte loads from consecutive threads (coalesced whatever
// K is), then each thread hashes its own row from shared memory, both hash
// streams in registers, and writes hi and lo (coalesced 8-byte stores).
//
// Limit, which the wrapper raises on: K <= 113, so that a block's stage
// (256 * K * 8 bytes of dynamic shared memory) fits the 227 KB a block may
// have; above 48 KB the launch raises the kernel's shared-memory limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kSeedHi = 0x9747B28Cu;
constexpr uint32_t kSeedLo = 0x3C6EF372u;
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr int kRows = 256;  // rows a block, one thread each
constexpr size_t kDefaultSmem = 48 * 1024;

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

__global__ void fingerprint_kernel(const unsigned long long* __restrict__ lanes,
                                   const uint8_t* __restrict__ valid,
                                   long long* __restrict__ hi,
                                   long long* __restrict__ lo, long long m,
                                   int k) {
  extern __shared__ __align__(16) unsigned long long stage[];
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)(m - row0 < kRows ? m - row0 : kRows);
  const int words = rows * k;
  const unsigned long long* src = lanes + row0 * k;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const ulonglong2* src2 = reinterpret_cast<const ulonglong2*>(src);
    ulonglong2* stage2 = reinterpret_cast<ulonglong2*>(stage);
    for (int j = threadIdx.x; j < words / 2; j += kRows) stage2[j] = __ldg(src2 + j);
    if ((words & 1) && threadIdx.x == 0) stage[words - 1] = __ldg(src + words - 1);
  } else {  // a view that starts off a 16-byte boundary
    for (int j = threadIdx.x; j < words; j += kRows) stage[j] = __ldg(src + j);
  }
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const long long row = row0 + threadIdx.x;
  uint32_t h1 = kSent, h2 = kSent;
  if (valid[row]) {
    const unsigned long long* r = stage + threadIdx.x * k;
    h1 = kSeedHi;
    h2 = kSeedLo;
    for (int i = 0; i < k; ++i) {
      const uint32_t v = (uint32_t)r[i];
      h1 = mix_lane(h1, v);
      h2 = mix_lane(h2, v);
    }
    h1 = fmix32(h1 ^ (uint32_t)(4 * k));
    h2 = fmix32(h2 ^ (uint32_t)(4 * k));
    if (h1 == kSent && h2 == kSent) h2 = 0xFFFFFFFEu;
  }
  hi[row] = (long long)h1;
  lo[row] = (long long)h2;
}

}  // namespace

extern "C" {

const char* kspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// lanes: i64[m, k] row-major holding u32 values; valid: u8[m] (a bool
// tensor's bytes); hi, lo: i64[m] outputs holding u32 values.  Every
// pointer is on card `device`, and `stream` is one of its streams.
// Launches there (the current device is set for the launch and put back)
// and returns the CUDA error code.
int kspec_fingerprint(const void* lanes, const void* valid, void* hi, void* lo,
                      long long m, int k, int device, void* stream) {
  if (m <= 0) return 0;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)kRows * k * sizeof(unsigned long long);
  if (smem > kDefaultSmem)
    e = cudaFuncSetAttribute(fingerprint_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    const long long blocks = (m + kRows - 1) / kRows;
    fingerprint_kernel<<<(unsigned)blocks, kRows, smem, (cudaStream_t)stream>>>(
        (const unsigned long long*)lanes, (const uint8_t*)valid, (long long*)hi,
        (long long*)lo, m, k);
    e = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}

}  // extern "C"
