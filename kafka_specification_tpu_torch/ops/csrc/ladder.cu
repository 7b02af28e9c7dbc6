// Kernel K4: the six rungs of the construct ladder, for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/tpu_mosaic_ladder.py (k_vec,
// k_loop_vec, k_static_scalar, k_dyn_read, k_dyn_slice, k_scalar_loop,
// :45-73): one construct each over u32[n], from a pure vector op down to a
// data-dependent scalar store and a scalar walk.  Semantics are those of
// ops/cuda_ladder.py's plain versions: all arithmetic in uint32_t (mod 2^32,
// an unsigned remainder), and pos = min(x[0] % 7, n - 1), clamped as JAX's
// pl.ds clamps a start that is out of range.
//
// Bound.  A rung reads x once and writes o once, 8 n bytes, with at most
// four integer operations an element, far below the card's operation rate:
//   n = 256   2 KB, 6.1e-7 ms at 3.35 TB/s: the time is the launch floor;
//   n = 2^24  134 MB, 0.0401 ms at 3.35 TB/s, well beyond the 50 MB L2: one
//             pass at the memory's rate, which the design below is for.
//
// Design.  Enough bytes in flight to cover the memory's latency, and every
// block short-lived: each block takes one contiguous chunk of the array,
// and the grid has as many blocks as chunks (n / 1024 of them, at most
// 2^21 for n < 2^31).  Grid-stride loops over a grid of resident blocks
// (8 an SM), each thread two 16-byte vectors ahead, ran slower at 2^24 on
// an H100 (PERF.md).
// - vec, loop_vec, static_scalar, dyn_read, dyn_slice: 16-byte accesses,
//   one uint4 (four u32) a thread, a load and a store; the tail of n % 4
//   elements with 4-byte accesses by the first threads of block 0.  When x
//   or o does not start on a 16-byte boundary (a view one element into its
//   storage) the rung takes the 4-byte path below.
// - dyn_read, dyn_slice: every thread reads x[0] (one address for the whole
//   grid, served from L1 and L2) and computes pos itself.
// - static_scalar, dyn_slice: the lane that holds pos writes x[pos] + 1 in
//   its one store, and no other thread writes o[pos]: each element is
//   written once, and no ordering between blocks is needed.
// - loop_vec: four trips of acc += v on each of the four values, the empty
//   asm making acc opaque every trip so the compiler cannot fold the loop
//   into one multiply.
// - scalar_loop: the TPU's construct is a fori_loop of scalar loads and
//   stores, and it ran in order because a Pallas kernel body runs on one
//   core.  o[i] = x[i] + 1 has no order in it, so on the card each thread
//   walks its own four elements of its block's chunk, 256 apart, with
//   4-byte loads (all four in flight) and then 4-byte stores, and never a
//   vector access: vec and scalar_loop still differ in what they time,
//   16- against 4-byte accesses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScalarsPerThread = 4;
constexpr int kChunk = kThreads * kScalarsPerThread;  // elements a block

enum Rung { kVec, kLoopVec, kStaticScalar, kDynRead, kDynSlice, kScalarLoop };

// what every thread reads of the data before its pass: pos, and x[pos]
struct Ctx {
  long long pos;
  uint32_t at_pos;
};

template <int R>
__device__ __forceinline__ Ctx context(const uint32_t* __restrict__ x,
                                       long long n) {
  Ctx c{0, 0};
  if (R == kDynRead || R == kDynSlice) {
    const long long p = x[0] % 7u;
    c.pos = p < n ? p : n - 1;
    if (R == kDynRead) c.at_pos = x[c.pos];
  }
  return c;
}

// the rung's value of element i, which holds v
template <int R>
__device__ __forceinline__ uint32_t apply(uint32_t v, long long i,
                                          const Ctx& c) {
  if (R == kVec) return v * 3u + 7u;
  if (R == kLoopVec) {
    uint32_t acc = 0;
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      acc += v;
      asm volatile("" : "+r"(acc));
    }
    return acc;
  }
  if (R == kStaticScalar) return i == 0 ? v + 1u : v;
  if (R == kDynRead) return v + c.at_pos;
  if (R == kDynSlice) return i == c.pos ? v + 1u : v;
  return v + 1u;  // scalar_loop
}

// elements i .. i + 3, held in one uint4
template <int R>
__device__ __forceinline__ uint4 apply4(uint4 a, long long i, const Ctx& c) {
  a.x = apply<R>(a.x, i, c);
  a.y = apply<R>(a.y, i + 1, c);
  a.z = apply<R>(a.z, i + 2, c);
  a.w = apply<R>(a.w, i + 3, c);
  return a;
}

// x and o 16-byte aligned: one vector a thread, then n % 4 scalars
template <int R>
__global__ void __launch_bounds__(kThreads)
    vec4_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
                long long n) {
  const Ctx c = context<R>(x, n);
  const long long nv = n >> 2;
  const long long v = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (v < nv) {
    const uint4 a = reinterpret_cast<const uint4*>(x)[v];
    reinterpret_cast<uint4*>(o)[v] = apply4<R>(a, v << 2, c);
  }
  const long long t = (nv << 2) + v;
  if (t < n) o[t] = apply<R>(x[t], t, c);
}

// 4-byte accesses only, four elements a thread: scalar_loop, and every
// rung on an unaligned view
template <int R>
__global__ void __launch_bounds__(kThreads)
    scalar_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
                  long long n) {
  const Ctx c = context<R>(x, n);
  const long long base = blockIdx.x * (long long)kChunk + threadIdx.x;
  uint32_t a[kScalarsPerThread];
#pragma unroll
  for (int k = 0; k < kScalarsPerThread; ++k) {
    const long long i = base + k * kThreads;
    if (i < n) a[k] = x[i];
  }
#pragma unroll
  for (int k = 0; k < kScalarsPerThread; ++k) {
    const long long i = base + k * kThreads;
    if (i < n) o[i] = apply<R>(a[k], i, c);
  }
}

using Kernel = void (*)(const uint32_t*, uint32_t*, long long);

// by rung, for 16-byte aligned x and o (scalar_loop never takes vectors)
const Kernel kAlignedKernels[] = {
    vec4_kernel<kVec>,     vec4_kernel<kLoopVec>,  vec4_kernel<kStaticScalar>,
    vec4_kernel<kDynRead>, vec4_kernel<kDynSlice>, scalar_kernel<kScalarLoop>};
const Kernel kScalarKernels[] = {
    scalar_kernel<kVec>,     scalar_kernel<kLoopVec>,
    scalar_kernel<kStaticScalar>, scalar_kernel<kDynRead>,
    scalar_kernel<kDynSlice>, scalar_kernel<kScalarLoop>};

cudaError_t launch(int rung, const void* x, void* o, long long n, int reps,
                   cudaStream_t stream) {
  const bool vector = (((uintptr_t)x | (uintptr_t)o) & 15) == 0 && rung != kScalarLoop;
  const Kernel kernel = vector ? kAlignedKernels[rung] : kScalarKernels[rung];
  // a chunk is kChunk elements either way: one vector a thread, or four
  // scalars; block 0 also takes the tail of a vector pass
  const unsigned blocks = (unsigned)((n + kChunk - 1) / kChunk);
  void* args[] = {(void*)&x, (void*)&o, (void*)&n};
  cudaError_t e = cudaSuccess;
  for (int r = 0; r < reps && e == cudaSuccess; ++r)
    e = cudaLaunchKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args, 0,
                         stream);
  return e;
}

}  // namespace

extern "C" {

const char* kspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rung: index into ("vec", "loop_vec", "static_scalar", "dyn_read",
// "dyn_slice", "scalar_loop"); x, o: u32[n], 1 <= n < 2^31, not
// overlapping, both on card `device`, and `stream` one of its streams.
// Launches the rung `reps` times back to back there (the current device is
// set for the launches and put back) and returns the CUDA error code.
int kspec_ladder(int rung, const void* x, void* o, long long n, int reps,
                 int device, void* stream) {
  if (n <= 0 || reps <= 0) return 0;
  if (rung < kVec || rung > kScalarLoop) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = launch(rung, x, o, n, reps, (cudaStream_t)stream);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}

}  // extern "C"
