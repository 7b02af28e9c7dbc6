// Kernel K2: insert-or-find of 64-bit fingerprints into an open-addressing
// table in device memory, for Hopper (sm_90a).
//
// Replaces the TPU kernels kafka_specification_tpu/ops/pallas_hashset.py:380
// probe_insert_pallas (bodies _kernel, _kernel_grouped) and :313
// probe_insert_pallas_hbm (body _kernel_hbm).  Contract, as there: the table
// has a power-of-two number of slots, the home slot of (hi, lo) is
// fmix32(lo ^ fmix32(hi)) & (cap - 1), probing is linear for at most
// max_probes slots counted from the home slot, and after the call is_new
// marks exactly the lowest-index valid row of each key that was not in the
// table before the call.  A row still unresolved after max_probes slots sets
// `overflow`; the caller then grows the table and re-runs the batch.
//
// Layout: one slot is one 64-bit word holding hi << 32 | lo; the empty slot
// is all ones (a key the fingerprints never take).  One word per slot is
// what lets a single 64-bit atomicCAS claim a slot.
//
// The TPU kernel gets its winner rule for free: its grid runs rows in order.
// Here blocks race, so the call is three steps with a grid-wide barrier
// between each and the next, in one cooperative launch (grid-stride loops
// on a grid of resident blocks, grid.sync() between the steps), with no
// fill before it:
//   1. find   - read-only probe from the home slot.  The table is not
//               written, so a row that meets its key knows the key was there
//               before the call.  Any other valid row records the first
//               empty slot it met (or that it met none in max_probes slots).
//               Thread 0 zeroes n_new and overflow.
//   2. insert - each pending row starts at the empty slot find met, not at
//               the home slot, with its probe budget still counted from the
//               home slot.  Within a call slots only go from empty to a key,
//               so the chain before that slot still holds no copy of the
//               key.  The row atomicCASes its key in (a CAS that returns the
//               same key means an in-batch duplicate got there first; every
//               copy of a key ends at one slot), then atomicMins its tagged
//               row, code << 32 | row, into that slot's claim word.
//   3. winner - is_new = (claim[slot] == code << 32 | row), written for
//               every row; a warp ballot counts the winners into n_new.
// The claim words are epoch-tagged.  The wrapper keeps one claim array per
// (device, stream), as long as the largest table seen there, fills it with
// all ones when it is made, and lowers `code` by one on every call, so a
// word this call writes is below every word an earlier call left, on this
// table or on any other (a table of cap slots uses the first cap words):
// the array is never reset, and step 2 no longer re-walks the chain that
// step 1 read.
// Reads of what another thread wrote in an earlier step go through L2
// (__ldcg), since L1 is not coherent across a grid barrier.
//
// The same steps as three launches on one stream were timed against the one
// launch at the main path's shape (cap 2^22, M = 109,260) on an H100: own
// time 0.0178-0.0187 ms against 0.0163-0.0168 ms, and slower through the
// wrapper too (PERF.md), so only the cooperative launch was kept.
//
// Limits, which the wrapper raises on: cap a power of two <= 2^31 (slots
// are int32 in the row scratch); M < 2^32 - 1 rows (the row is the low half
// of a claim word, and all ones is the fill).  The C entry refuses a device
// index of 64 or more (it keeps the resident block count per device).
//
// Bound: memory latency.  Each row reads its 8-byte key and at least one
// 8-byte slot; the slot and claim accesses are scattered, one 32-byte sector
// each, and the three steps depend on each other through the table, so the
// grid waits twice for its slowest row.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kDone = -2;      // invalid row, or key already in the table
constexpr int kOverflow = -1;  // no slot within max_probes
constexpr int kThreads = 256;

struct Args {
  unsigned long long* table;
  unsigned long long* claim;
  long long cap;
  const unsigned long long* q;
  const uint8_t* valid;  // null: every row is valid
  long long m;
  int max_probes;
  unsigned long long tag;  // code << 32
  int* slot;
  uint8_t* is_new;
  int* counts;  // [n_new, overflow]
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ long long home_slot(unsigned long long key,
                                               long long mask) {
  uint32_t hi = (uint32_t)(key >> 32), lo = (uint32_t)key;
  return (long long)(fmix32(lo ^ fmix32(hi))) & mask;
}

__device__ __forceinline__ void find_row(const Args& a, long long i) {
  if (a.valid != nullptr && !a.valid[i]) {
    a.slot[i] = kDone;
    return;
  }
  const unsigned long long key = a.q[i];
  const long long mask = a.cap - 1;
  long long pos = home_slot(key, mask);
  int state = kOverflow;
  for (int p = 0; p < a.max_probes; ++p) {
    unsigned long long cur = __ldcg(a.table + pos);
    if (cur == key) {
      state = kDone;
      break;
    }
    if (cur == kEmpty) {
      state = (int)pos;
      break;
    }
    pos = (pos + 1) & mask;
  }
  a.slot[i] = state;
}

__device__ __forceinline__ void insert_row(const Args& a, long long i) {
  const int s = __ldcg(a.slot + i);
  if (s == kDone) return;
  if (s == kOverflow) {
    a.counts[1] = 1;
    return;
  }
  const unsigned long long key = a.q[i];
  const long long mask = a.cap - 1;
  long long pos = s;
  for (int p = (int)((pos - home_slot(key, mask)) & mask); p < a.max_probes; ++p) {
    // a stale read is either the value now there or `empty`, which the CAS
    // below settles
    unsigned long long cur = __ldcg(a.table + pos);
    if (cur == kEmpty) {
      cur = atomicCAS(a.table + pos, kEmpty, key);
      if (cur == kEmpty) cur = key;  // this row filled the slot
    }
    if (cur == key) {
      a.slot[i] = (int)pos;
      atomicMin(a.claim + pos, a.tag | (unsigned long long)i);
      return;
    }
    pos = (pos + 1) & mask;
  }
  a.slot[i] = kOverflow;
  a.counts[1] = 1;
}

__device__ __forceinline__ bool winner_row(const Args& a, long long i) {
  const int s = __ldcg(a.slot + i);
  const bool won = s >= 0 && __ldcg(a.claim + s) == (a.tag | (unsigned long long)i);
  a.is_new[i] = won;
  return won;
}

__global__ void probe_insert_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t == 0) {
    a.counts[0] = 0;
    a.counts[1] = 0;
  }
  for (long long i = t; i < a.m; i += stride) find_row(a, i);
  grid.sync();
  for (long long i = t; i < a.m; i += stride) insert_row(a, i);
  grid.sync();
  // whole warps go round together, so the ballot sees all 32 lanes
  const int lane = threadIdx.x & 31;
  for (long long base = t - lane; base < a.m; base += stride) {
    const long long i = base + lane;
    const bool won = i < a.m && winner_row(a, i);
    unsigned ballot = __ballot_sync(0xFFFFFFFFu, won);
    if (lane == 0 && ballot) atomicAdd(a.counts, __popc(ballot));
  }
}

constexpr int kMaxDevices = 64;

// resident blocks of the kernel on `dev`, the current device; asked once
// per device
cudaError_t resident_blocks(int dev, int* out) {
  static int resident[kMaxDevices] = {};
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_insert_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident[dev] = sms * per_sm;
  }
  *out = resident[dev];
  return cudaSuccess;
}

cudaError_t launch(int device, const Args& a, cudaStream_t stream) {
  int resident = 0;
  cudaError_t e = resident_blocks(device, &resident);
  if (e != cudaSuccess) return e;
  // one block even for m == 0: the kernel zeroes the counts
  const long long want = (a.m + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : (want < resident ? want : resident));
  void* params[] = {const_cast<Args*>(&a)};
  return cudaLaunchCooperativeKernel((const void*)probe_insert_kernel, dim3(blocks),
                                     dim3(kThreads), params, 0, stream);
}

}  // namespace

extern "C" {

const char* kspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table: u64[cap] (cap a power of two, updated in place); claim: u64[>= cap]
// claim words, never reset; q: u64[m] keys; valid: u8[m] or null; code:
// this call's claim tag, below every earlier call's on `claim`; slot:
// i32[>= m] scratch; is_new: u8[m] out; counts: i32[2] out (n_new,
// overflow), zeroed here.  Every pointer is on card `device`, and `stream`
// is one of its streams.  Launches the kernel there (the current device is
// set for the launch and put back) and returns the CUDA error code.
int kspec_probe_insert(void* table, void* claim, long long cap, const void* q,
                       const void* valid, long long m, int max_probes,
                       unsigned int code, void* slot, void* is_new,
                       void* counts, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Args a{(unsigned long long*)table,
         (unsigned long long*)claim,
         cap,
         (const unsigned long long*)q,
         (const uint8_t*)valid,
         m,
         max_probes,
         (unsigned long long)code << 32,
         (int*)slot,
         (uint8_t*)is_new,
         (int*)counts};
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = launch(device, a, (cudaStream_t)stream);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}

}  // extern "C"
