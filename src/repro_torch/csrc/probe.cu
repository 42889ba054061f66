// Wait-free batched lookup for Hopper (sm_90a): K3 of the port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/probe/probe.py
// _probe_kernel (launched by probe_lookup_kernel): from h(key), scan the
// table in linear probe order for (key << 2) | TAG_FINAL before the first
// EMPTY cell; return found and slot (-1 when absent).
//
// Bound on this card: bytes.  A lookup does one compare per cell it reads,
// so the least time is the cells each key's run needs (4 B each) plus the
// key, hash and two results, over 3.35 TB/s.
//
// Design: the TPU kernel sorted keys by hash, staged two TB-cell table
// blocks per key tile in VMEM and sliced only along sublanes; keys whose run
// left that window were "unresolved" and fell back to the oracle.  Those
// were devices for VMEM.  Here one warp serves one key: each round reads 32
// consecutive cells (coalesced, wrapping mod m), __ballot_sync marks the
// hits and the EMPTY cells, and the lower set bit decides.  The walk goes
// on until it decides or has read all m cells, so every key is resolved,
// any m works, and no fallback is needed.  The hash is computed by the
// caller with the same code as the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMPTY = ((1 << 28) - 1) << 2;  // (RESERVED_KEY << 2) | 0
constexpr int TAG_FINAL = 1;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32) probe_kernel(
    const int* __restrict__ table, int m, const int* __restrict__ keys,
    const int* __restrict__ hv, int n, int* __restrict__ found,
    int* __restrict__ slot) {
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n) return;                          // whole warp leaves together
  const int target = (keys[w] << 2) | TAG_FINAL;
  const int h = hv[w];
  for (int base = 0; base < m; base += 32) {
    const int off = base + lane;
    const bool valid = off < m;
    int idx = h + off;
    if (idx >= m) idx -= m;                    // h < m and off < m
    const int cell = valid ? table[idx] : EMPTY;
    const unsigned hit = __ballot_sync(0xffffffffu, valid && cell == target);
    const unsigned end = __ballot_sync(0xffffffffu, valid && cell == EMPTY);
    const unsigned any = hit | end;
    if (any) {
      const int first = __ffs(any) - 1;
      if (lane == 0) {
        const bool is_hit = (hit >> first) & 1u;
        int s = h + base + first;
        if (s >= m) s -= m;
        found[w] = is_hit ? 1 : 0;
        slot[w] = is_hit ? s : -1;
      }
      return;
    }
  }
  if (lane == 0) {                             // read all m cells: absent
    found[w] = 0;
    slot[w] = -1;
  }
}

}  // namespace

extern "C" int probe_lookup_launch(const void* table, int m, const void* keys,
                                   const void* hv, int n, void* found,
                                   void* slot, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + WARPS - 1) / WARPS;
  probe_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)table, m, (const int*)keys, (const int*)hv, n, (int*)found,
      (int*)slot);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
