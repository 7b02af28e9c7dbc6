// Kernel K2: insert-or-find of 64-bit fingerprints into an open-addressing
// table in device memory, for Hopper (sm_90a).
//
// Replaces the TPU kernels kafka_specification_tpu/ops/pallas_hashset.py
// probe_insert_pallas (bodies _kernel, _kernel_grouped) and
// probe_insert_pallas_hbm (body _kernel_hbm).  Contract, as there: the table
// has a power-of-two number of slots, the home slot of (hi, lo) is
// fmix32(lo ^ fmix32(hi)) & (cap - 1), probing is linear for at most
// max_probes slots, and after the call is_new marks exactly the lowest-index
// valid row of each key that was not in the table before the call.  A row
// still unresolved after max_probes slots sets `overflow`; the caller then
// grows the table and re-runs the batch.
//
// Layout: one slot is one 64-bit word holding hi << 32 | lo; the empty slot
// is all ones (a key the fingerprints never take).  One word per slot is
// what lets a single 64-bit atomicCAS claim a slot.
//
// The TPU kernel gets its winner rule for free: its grid runs rows in order.
// Here blocks race, so the call is four short launches on one stream, each a
// grid-wide barrier for the next:
//   1. find   - read-only probe.  The table is not written, so a row that
//               meets its key knows the key was there before the call.
//   2. insert - the other valid rows probe again and atomicCAS their key into
//               the first empty slot.  A CAS that returns the same key means
//               an in-batch duplicate got there first; every copy of a key
//               ends at the same slot.  The row whose CAS filled the slot
//               resets that slot's claim word.
//   3. claim  - atomicMin of the row index into the claim word of its slot.
//   4. winner - is_new = (claim[slot] == row); n_new counts the winners.
// The claim array needs no initialisation: step 2 resets exactly the words
// that step 3 reads, which belong to slots filled in this call.
//
// Bound: memory latency.  Each row reads its 8-byte key and at least one
// 8-byte slot; the slot reads are scattered, one 32-byte sector each.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kSeen = -3;     // key was in the table before the call
constexpr int kSkip = -2;     // invalid row
constexpr int kPending = -1;  // not found; to insert (or overflowed)

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

__global__ void find_kernel(const unsigned long long* __restrict__ table,
                            long long cap, const unsigned long long* __restrict__ q,
                            const uint8_t* __restrict__ valid, long long m,
                            int max_probes, int* __restrict__ slot) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  if (!valid[i]) {
    slot[i] = kSkip;
    return;
  }
  const unsigned long long key = q[i];
  const long long mask = cap - 1;
  long long pos = home_slot(key, mask);
  int state = kPending;
  for (int p = 0; p < max_probes; ++p) {
    unsigned long long cur = table[pos];
    if (cur == key) {
      state = kSeen;
      break;
    }
    if (cur == kEmpty) break;
    pos = (pos + 1) & mask;
  }
  slot[i] = state;
}

__global__ void insert_kernel(unsigned long long* table, int* claim,
                              long long cap,
                              const unsigned long long* __restrict__ q,
                              long long m, int max_probes,
                              int* __restrict__ slot, int* overflow) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m || slot[i] != kPending) return;
  const unsigned long long key = q[i];
  const long long mask = cap - 1;
  long long pos = home_slot(key, mask);
  for (int p = 0; p < max_probes; ++p) {
    // slots only ever go from empty to a key, so a stale read is either the
    // value now there or `empty`, which the CAS below settles
    unsigned long long cur = ((volatile unsigned long long*)table)[pos];
    if (cur == kEmpty) {
      cur = atomicCAS(&table[pos], kEmpty, key);
      if (cur == kEmpty) {
        claim[pos] = INT_MAX;
        slot[i] = (int)pos;
        return;
      }
    }
    if (cur == key) {
      slot[i] = (int)pos;
      return;
    }
    pos = (pos + 1) & mask;
  }
  *overflow = 1;
}

__global__ void claim_kernel(int* claim, const int* __restrict__ slot,
                             long long m) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  int s = slot[i];
  if (s >= 0) atomicMin(&claim[s], (int)i);
}

__global__ void winner_kernel(const int* __restrict__ claim,
                              const int* __restrict__ slot, long long m,
                              uint8_t* __restrict__ is_new, int* n_new) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  int s = slot[i];
  bool won = s >= 0 && claim[s] == (int)i;
  is_new[i] = won;
  unsigned ballot = __ballot_sync(__activemask(), won);
  if (won && (threadIdx.x & 31) == __ffs(ballot) - 1)
    atomicAdd(n_new, __popc(ballot));
}

}  // namespace

extern "C" {

const char* kspec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table: u64[cap] (cap a power of two, updated in place); claim: i32[cap]
// scratch, any contents; q: u64[m] keys; valid: u8[m]; slot: i32[m] scratch;
// is_new: u8[m] out; n_new, overflow: i32[1], zeroed by the caller.
// Launches the four steps on `stream` and returns the CUDA error code.
int kspec_probe_insert(void* table, void* claim, long long cap, const void* q,
                       const void* valid, long long m, int max_probes,
                       void* slot, void* is_new, void* n_new, void* overflow,
                       void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned blocks = (unsigned)((m + threads - 1) / threads);
  auto* t = (unsigned long long*)table;
  auto* c = (int*)claim;
  auto* qk = (const unsigned long long*)q;
  auto* sl = (int*)slot;
  find_kernel<<<blocks, threads, 0, s>>>(t, cap, qk, (const uint8_t*)valid, m,
                                         max_probes, sl);
  insert_kernel<<<blocks, threads, 0, s>>>(t, c, cap, qk, m, max_probes, sl,
                                           (int*)overflow);
  claim_kernel<<<blocks, threads, 0, s>>>(c, sl, m);
  winner_kernel<<<blocks, threads, 0, s>>>(c, sl, m, (uint8_t*)is_new,
                                           (int*)n_new);
  return (int)cudaGetLastError();
}

}  // extern "C"
