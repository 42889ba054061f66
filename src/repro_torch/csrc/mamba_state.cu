// The mamba state update of one decode token for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's mamba decode step is plain
// jnp (src/repro/models/ssm.py mamba_decode_step).  It was added because
// the port's one-device decode (models/ssm.py mamba_decode_step_) made
// about seven passes over each layer's float32 state h in plain PyTorch
// (h * dA in place, the increment B x dt written whole, the in-place add's
// reads and write, the C.h read), and those passes took most of a decode
// step's device time on a hybrid model at a large batch.  Its plain
// version is kernels/mamba_state/ref.py mamba_state_plain.
//
// For each lane b, group g, head hh and row p, one pass over the row
// h[b,g,hh,p,:] of N floats:
//   kept lane:   h' = fl(fl(h * dA) + fl(B[n] * xdt)),  xdt = fl(x * dtp),
//                written in place;  y = sum_n C[n] h'[n]
//   frozen lane: h is not written (its bits stay, signed zeros included);
//                y = fl(fl(dA * sum_n C[n] h[n]) + fl((C.B) * xdt)), the
//                output of the advanced state rebuilt as the plain path does
//   then y = fl(y + fl(x * D)), rounded to the activation dtype and back,
//   written as float32 into y[b, (g*Hg + hh)*P + p].
// The state's arithmetic is spelled with __fmul_rn and __fadd_rn, which the
// compiler does not contract into an FMA, so h' takes the same bits as the
// plain path's mul_ and add_ (PyTorch's elementwise kernels round each
// product and each sum).  Only the order of the C.h sum differs from the
// plain path's gemv (and of C.B from its einsum).
//
// Bound on this card: bytes.  A row is read once and written once (kept
// lanes) for 3 flops an element of the update and 2 of the read-out: 5
// flops per 8 bytes, far below the card's ridge.  The least time is
// 2 x B x G x Hg x P x N x 4 bytes over 3.35 TB/s: 0.641 ms a layer of
// granite-4.0-h-small at 256 lanes (1.07 GB of h).  The design is a pure
// stream:
//  * One warp a tile of TILE rows of one head.  Lane l holds float4 l (and
//    l + 32 when N > 128) of a row: 16-byte accesses, neighbouring lanes on
//    neighbouring addresses, a row of N = 128 one 512-byte access a warp.
//    B and C of the (lane, group) sit in registers, four values a lane a
//    float4; dA, dtp, D and keep are scalars a warp.
//  * ROWS rows are loaded before any is used (ROWS x 512 bytes a warp in
//    flight; at 58 registers a thread, 4 blocks of 8 warps an SM, ~64 KB
//    an SM), with the streaming hints __ldcs and __stcs: the state (19.3 GB
//    over a model's layers) never fits the 50 MB L2.
//  * The C.h sums of the ROWS rows are reduced together by a __shfl_xor
//    butterfly (no shared memory, no barrier).
//  * Tiles of TILE = 16 rows keep each block's work small, so the blocks
//    the hardware hands out last leave little tail (4 tiles a head at
//    P = 64, 16,384 blocks a layer of the cell).
//  * No atomics, no host sync, nothing allocated: the same bits every run.
// N must be a multiple of 4 up to 256 (one or two float4s a lane), which
// the wrapper checks; lanes past N/4 are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int TILE = 16;    // rows of one head a warp owns
constexpr int ROWS = 4;     // rows a warp has in flight
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// y.to(activation dtype).float()
__device__ __forceinline__ float round_trip(float y, const float*) {
  return y;
}
__device__ __forceinline__ float round_trip(float y, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(y));
}

__device__ __forceinline__ float4 update(float4 q, float a, const float* b,
                                         float xdt) {
  q.x = __fadd_rn(__fmul_rn(q.x, a), __fmul_rn(b[0], xdt));
  q.y = __fadd_rn(__fmul_rn(q.y, a), __fmul_rn(b[1], xdt));
  q.z = __fadd_rn(__fmul_rn(q.z, a), __fmul_rn(b[2], xdt));
  q.w = __fadd_rn(__fmul_rn(q.w, a), __fmul_rn(b[3], xdt));
  return q;
}

__device__ __forceinline__ float dot4(float4 q, const float* c, float s) {
  s = fmaf(c[0], q.x, s);
  s = fmaf(c[1], q.y, s);
  s = fmaf(c[2], q.z, s);
  return fmaf(c[3], q.w, s);
}

// V: float4s a lane holds of a row (1 for N <= 128, 2 up to 256).
template <typename T, int V>
__global__ void __launch_bounds__(WARPS * 32) mamba_state_kernel(
    float* __restrict__ h, const float* __restrict__ dA,
    const float* __restrict__ dtp, const T* __restrict__ xs,
    const T* __restrict__ bc, const float* __restrict__ D,
    const uint8_t* __restrict__ keep, float* __restrict__ y, int tiles,
    int G, int Hg, int P, int N) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= tiles) return;                   // whole warp leaves together
  const int per_head = (P + TILE - 1) / TILE;
  const int head = tile / per_head;            // (b * G + g) * Hg + hh
  const int p0 = (tile % per_head) * TILE;
  const int p1 = min(P, p0 + TILE);
  const int hh = head % Hg;
  const int g = (head / Hg) % G;
  const int b = head / (Hg * G);
  const int nv = N >> 2;

  float bv[V][4], cv[V][4];
  const T* row_bc = bc + (size_t)b * 2 * G * N + (size_t)g * N;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int f = lane + 32 * v;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[v][j] = f < nv ? to_f32(row_bc[4 * f + j]) : 0.f;
      cv[v][j] = f < nv ? to_f32(row_bc[(size_t)G * N + 4 * f + j]) : 0.f;
    }
  }
  const float a = dA[head], dt = dtp[head], d = D[g * Hg + hh];
  const bool kept = keep[b] != 0;
  float cb = 0.f;                              // C.B, frozen lanes only
  if (!kept) {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb = fmaf(cv[v][j], bv[v][j], cb);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cb += __shfl_xor_sync(FULL, cb, o);
  }
  float4* hp = reinterpret_cast<float4*>(h + (size_t)head * P * N);
  const T* xp = xs + (size_t)head * P;         // xs [B, di], di = G*Hg*P
  float* yp = y + (size_t)head * P;

  for (int p = p0; p < p1; p += ROWS) {
    float4 r[ROWS][V];
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int f = lane + 32 * v;
        if (p + u < p1 && f < nv)
          r[u][v] = __ldcs(hp + (size_t)(p + u) * nv + f);
        else
          r[u][v] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    float xv[ROWS], s[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      xv[u] = p + u < p1 ? to_f32(xp[p + u]) : 0.f;
      const float xdt = __fmul_rn(xv[u], dt);
      s[u] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int f = lane + 32 * v;
        if (p + u < p1 && f < nv) {
          if (kept) {
            r[u][v] = update(r[u][v], a, bv[v], xdt);
            __stcs(hp + (size_t)(p + u) * nv + f, r[u][v]);
          }
          s[u] = dot4(r[u][v], cv[v], s[u]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < ROWS; ++u) s[u] += __shfl_xor_sync(FULL, s[u], o);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (p + u >= p1) break;
        float out = s[u];
        if (!kept)
          out = __fadd_rn(__fmul_rn(out, a), __fmul_rn(cb, __fmul_rn(xv[u],
                                                                      dt)));
        out = __fadd_rn(out, __fmul_rn(xv[u], d));
        yp[p + u] = round_trip(out, xp);
      }
    }
  }
}

template <typename T>
int launch(void* h, const void* dA, const void* dtp, const void* xs,
           const void* bc, const void* D, const void* keep, void* y, int B,
           int G, int Hg, int P, int N, cudaStream_t st) {
  const long long tiles =
      (long long)B * G * Hg * ((P + TILE - 1) / TILE);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((tiles + WARPS - 1) / WARPS);
#define ARGS                                                                \
  (float*)h, (const float*)dA, (const float*)dtp, (const T*)xs,             \
      (const T*)bc, (const float*)D, (const uint8_t*)keep, (float*)y,       \
      (int)tiles, G, Hg, P, N
  if (N <= 128)
    mamba_state_kernel<T, 1><<<blocks, WARPS * 32, 0, st>>>(ARGS);
  else
    mamba_state_kernel<T, 2><<<blocks, WARPS * 32, 0, st>>>(ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// h float32[B, G, Hg, P, N] (updated in place), dA and dtp float32[B, G, Hg],
// xs [B, G*Hg*P] and bc [B, 2*G*N] (B's streams, then C's) in the activation
// dtype, D float32[G*Hg], keep uint8[B] (torch.bool); y float32[B, G*Hg*P].
// All contiguous; N a multiple of 4 up to 256.  dtype codes: 0 float32,
// 1 bfloat16 (kernels/_build.py).
extern "C" int mamba_state_launch(void* h, const void* dA, const void* dtp,
                                  const void* xs, const void* bc,
                                  const void* D, const void* keep, void* y,
                                  int B, int G, int Hg, int P, int N,
                                  int dtype, void* stream) {
  if (B == 0 || G == 0 || Hg == 0 || P == 0) return 0;
  if (N < 4 || N > 256 || N % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(h, dA, dtp, xs, bc, D, keep, y, B, G, Hg, P, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, dA, dtp, xs, bc, D, keep, y, B, G, Hg, P,
                                 N, st);
  return (int)cudaErrorInvalidValue;
}
