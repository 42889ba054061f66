// Wait-free batched lookup for Hopper (sm_90a): K3 of the port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/probe/probe.py
// _probe_kernel (launched by probe_lookup_kernel): from h(key), scan the
// table in linear probe order for (key << 2) | TAG_FINAL before the first
// EMPTY cell; return found and slot (-1 when absent).
//
// Bound on this card: bytes.  A lookup does one compare per cell, so the
// least time is the bytes the call must move once: the union of the table
// cells the keys' runs cover (each cell counted once, 4 B), 8 B of int64
// key, 1 B of found and 4 B of slot per lookup and the 4-byte seed, over
// 3.35 TB/s (kernels/probe/probe.py lookup_bytes).  What holds the kernel
// back is not that bound: each lookup is a chain of dependent loads (its
// key, then its run, round by round), and the runs of lookups that miss at
// high load are long, so the walk is bound by the L2's latency and by its
// throughput for scattered 16-byte reads.  The design keeps many chains in
// flight, makes each chain short, and reads no more than a round needs.
//
// Design:
// * One launch per call.  The hash is computed here, bit for bit the
//   reference's uint32 hash (core/hashing.py hash_keys after
//   core/batched.py _hash): x = (key ^ seed * 0x9E3779B9) * A0, then
//   x >> (32 - k) for m = 2^k, else ((x >> 16) * m mod 2^32) >> 16.  The
//   seed is read from the table's int32 device scalar, so the wrapper
//   neither syncs nor runs a PyTorch op; keys are read as int64 (their low
//   32 bits, as the reference's uint32 view takes them) and found is
//   written as one byte, so the caller's tensors need no conversion.
// * Several keys a warp.  A group of L lanes serves one key; each lane
//   loads 16 aligned bytes (4 cells), so a group reads 16 L bytes a round
//   from a 16-byte-aligned base at or below h.  Each lane finds its first
//   hit or EMPTY among its 4 cells; one __ballot_sync gives every group its
//   first lane with such an event, and that lane decides.  A decided group
//   keeps voting with zero bits until the whole warp is done, so no vote
//   runs under divergence.  The walk covers [h, m) then [0, h), vector by
//   vector; a vector that would read past m is read cell by cell.  It goes
//   on until it decides or has read all m cells, so every key is resolved
//   and there is no fallback leg.
// * L trades bytes against rounds: a larger group reads more cells it does
//   not need on a short run, a smaller one takes more dependent rounds on a
//   long run.  L is the template parameter of probe_kernel, and one value,
//   LANES, is built and launched; tools/probe_variants.py builds copies at
//   the other L (4, 8, 16 or 32) and times them, and LANES was picked so.
// * kernels/probe/ref.py probe_walk_plain is a plain model of these rounds
//   (vectors, groups, masking, the wrap at m), which the CPU tests hold to
//   find_batch at every L: change each with the other.
// * The TPU kernel sorted keys by hash to stage two TB-cell table blocks per
//   key tile in VMEM.  A sort of the keys would cost more than the locality
//   it buys while the table sits in the 50 MB L2, so there is none.
//
// Why CUDA C++ and not Triton: the design rests on warp votes over lane
// groups (__ballot_sync, __any_sync) and on a loop whose trip count each
// warp decides for itself; Triton's block model has no warp-level vote and
// runs a block's loop in lockstep over all its keys.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMPTY = ((1 << 28) - 1) << 2;  // (RESERVED_KEY << 2) | 0
constexpr uint32_t TAG_FINAL = 1u;
constexpr uint32_t SEED_MIX = 0x9E3779B9u;   // core/batched.py _hash
constexpr int WARPS = 8;
constexpr int LANES = 16;                    // L: kernels/probe/probe.py LANES
constexpr unsigned FULL = 0xffffffffu;

// h(key) in [0, m): shift = 32 - k for m = 2^k (32 for m = 1: bucket 0),
// shift < 0 for any other m (the general branch, which wraps in uint32).
__device__ __forceinline__ int bucket(uint32_t key, uint32_t seed,
                                      uint32_t a0, int m, int shift) {
  const uint32_t x = (key ^ (seed * SEED_MIX)) * a0;
  if (shift >= 0) return shift >= 32 ? 0 : (int)(x >> shift);
  return (int)(((x >> 16) * (uint32_t)m) >> 16);
}

template <int L>
__global__ void __launch_bounds__(WARPS * 32) probe_kernel(
    const int* __restrict__ table, int m, const long long* __restrict__ keys,
    int n, const int* __restrict__ seed, uint32_t a0, int shift,
    uint8_t* __restrict__ found, int* __restrict__ slot) {
  constexpr int G = 32 / L;                    // keys a warp
  const int lane = threadIdx.x & 31;
  const int g = lane / L, gl = lane % L;
  const int first = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * G;
  if (first >= n) return;                      // whole warp leaves together
  const int i = first + g;
  bool active = i < n;
  const uint32_t key = active ? (uint32_t)keys[i] : 0u;
  const int h = bucket(key, (uint32_t)__ldg(seed), a0, m, shift);
  const int target = (int)((key << 2) | TAG_FINAL);
  const int base = h & ~3;
  const int nv1 = (m - base + 3) >> 2;         // vectors of [base, m)
  const int nv = nv1 + ((h + 3) >> 2);         // then those of [0, h)
  const unsigned mine = (L == 32 ? FULL : (1u << (L & 31)) - 1u) << (g * L);
  for (int r = 0; __any_sync(FULL, active); ++r) {
    const int v = r * L + gl;
    bool event = false, hit = false;
    int at = 0;
    if (active && v < nv) {
      int p, lo, hi;                           // live cells: [lo, hi)
      if (v < nv1) {
        p = base + 4 * v, lo = h, hi = m;
      } else {
        p = 4 * (v - nv1), lo = 0, hi = h;
      }
      int c[4];
      if (p + 4 <= m) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(table + p));
        c[0] = q.x, c[1] = q.y, c[2] = q.z, c[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = p + j < m ? __ldg(table + p + j)
                                                     : EMPTY;
      }
#pragma unroll
      for (int j = 3; j >= 0; --j) {           // the first event wins
        const int cell = p + j;
        if (cell >= lo && cell < hi && (c[j] == target || c[j] == EMPTY)) {
          event = true;
          hit = c[j] == target;
          at = cell;
        }
      }
    }
    const unsigned votes = __ballot_sync(FULL, event) & mine;
    if (active) {
      if (votes) {
        if (lane == __ffs(votes) - 1) {
          found[i] = hit ? 1 : 0;
          slot[i] = hit ? at : -1;
        }
        active = false;
      } else if ((r + 1) * L >= nv) {          // read all m cells: absent
        if (gl == 0) {
          found[i] = 0;
          slot[i] = -1;
        }
        active = false;
      }
    }
  }
}

}  // namespace

// table int32[m] (16-byte aligned), keys int64[n], seed int32[] on the
// device; found uint8[n] (torch.bool), slot int32[n].
extern "C" int probe_lookup_launch(const void* table, int m, const void* keys,
                                   int n, const void* seed, unsigned a0,
                                   int shift, void* found, void* slot,
                                   void* stream) {
  if (n == 0) return 0;
  constexpr int per_block = WARPS * (32 / LANES);
  probe_kernel<LANES><<<(n + per_block - 1) / per_block, WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
      (const int*)table, m, (const long long*)keys, n, (const int*)seed, a0,
      shift, (uint8_t*)found, (int*)slot);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
