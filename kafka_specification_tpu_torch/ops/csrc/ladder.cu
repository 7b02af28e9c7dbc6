// Kernel K4: the six rungs of the construct ladder, for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/tpu_mosaic_ladder.py (k_vec,
// k_loop_vec, k_static_scalar, k_dyn_read, k_dyn_slice, k_scalar_loop,
// :45-73): one construct each over u32[n], from a pure vector op down to a
// data-dependent scalar store and a serial scalar walk.  Each rung keeps its
// construct, so that its time means what the rung is named for.  Semantics
// are those of ops/cuda_ladder.py's plain versions: all arithmetic in
// uint32_t (mod 2^32, an unsigned remainder), and
// pos = min(x[0] % 7, n - 1), clamped as JAX's pl.ds clamps a start that is
// out of range.
//
// Bound: at the ladder's n = 256 a rung reads 1 KB and writes 1 KB, under a
// nanosecond of the card's memory time, so every rung's time is the launch
// floor (and for scalar_loop one thread's serial walk).  At large n every
// rung but scalar_loop is one memory-bound pass over x.
//
// Blocks run in no order.  A "copy, then store one element" rung
// (static_scalar, dyn_slice) therefore lets only the block that copies
// element pos store it: that block copies, meets __syncthreads(), and then
// its thread 0 writes o[pos].  The other blocks only copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long element() {
  return blockIdx.x * (long long)blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long clamped_pos(const uint32_t* x,
                                                 long long n) {
  const long long p = x[0] % 7u;
  return p < n ? p : n - 1;
}

// vec: o = x * 3 + 7, one thread per element
__global__ void vec_kernel(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ o, long long n) {
  const long long i = element();
  if (i < n) o[i] = x[i] * 3u + 7u;
}

// loop_vec: four trips of acc += x.  The empty asm makes acc opaque on every
// trip, so the compiler cannot fold the loop into one multiply.
__global__ void loop_vec_kernel(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ o, long long n) {
  const long long i = element();
  if (i >= n) return;
  uint32_t acc = 0;
#pragma unroll 1
  for (int t = 0; t < 4; ++t) {
    acc += x[i];
    asm volatile("" : "+r"(acc));
  }
  o[i] = acc;
}

// static_scalar (pos 0) and dyn_slice (pos from x[0] on the card): copy,
// then one scalar store of x[pos] + 1 by the block that copied element pos
template <bool kDynamic>
__global__ void copy_then_store_kernel(const uint32_t* __restrict__ x,
                                       uint32_t* __restrict__ o, long long n) {
  const long long i = element();
  if (i < n) o[i] = x[i];
  const long long pos = kDynamic ? clamped_pos(x, n) : 0;
  if (pos / blockDim.x != blockIdx.x) return;  // the same for the whole block
  __syncthreads();
  if (threadIdx.x == 0) o[pos] = x[pos] + 1u;
}

// dyn_read: o = x + x[pos], a load whose address comes from the data
__global__ void dyn_read_kernel(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ o, long long n) {
  const long long i = element();
  if (i < n) o[i] = x[i] + x[clamped_pos(x, n)];
}

// scalar_loop: one thread walks every element in order
__global__ void scalar_loop_kernel(const uint32_t* __restrict__ x,
                                   uint32_t* __restrict__ o, long long n) {
#pragma unroll 1
  for (long long i = 0; i < n; ++i) o[i] = x[i] + 1u;
}

}  // namespace

extern "C" {

const char* kspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rung: index into ("vec", "loop_vec", "static_scalar", "dyn_read",
// "dyn_slice", "scalar_loop"); x, o: u32[n], 1 <= n < 2^31.  Launches the
// rung `reps` times back to back on `stream` and returns the CUDA error code.
int kspec_ladder(int rung, const void* x, void* o, long long n, int reps,
                 void* stream) {
  if (n <= 0 || reps <= 0) return 0;
  if (rung < 0 || rung > 5) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto* xi = (const uint32_t*)x;
  auto* oi = (uint32_t*)o;
  for (int r = 0; r < reps; ++r) {
    switch (rung) {
      case 0: vec_kernel<<<blocks, kThreads, 0, s>>>(xi, oi, n); break;
      case 1: loop_vec_kernel<<<blocks, kThreads, 0, s>>>(xi, oi, n); break;
      case 2:
        copy_then_store_kernel<false><<<blocks, kThreads, 0, s>>>(xi, oi, n);
        break;
      case 3: dyn_read_kernel<<<blocks, kThreads, 0, s>>>(xi, oi, n); break;
      case 4:
        copy_then_store_kernel<true><<<blocks, kThreads, 0, s>>>(xi, oi, n);
        break;
      default: scalar_loop_kernel<<<1, 1, 0, s>>>(xi, oi, n); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
