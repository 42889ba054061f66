// Paged decode attention for Hopper (sm_90a): K1 and K2 of the port.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1  src/repro/kernels/fused_decode/fused.py  _fused_kernel
//       (launched by fused_decode_kernel): walks the RAW block-table row
//       bt[b, :MP]; page p is live iff p*PS <= pos[b] and bt[b,p] >= 0;
//       only live pages are read.  Normalized output, or the f32
//       (o, m, l) partials the engine merges.
//   K2  src/repro/kernels/paged_attention/paged_attention.py  _pa_kernel
//       (launched by paged_attention_kernel): reads page page_ids[b,p];
//       valid tokens are p*PS+i < lens[b] with id >= 0; a page with no
//       valid token is skipped.  Normalized output.
//
// Bound on this card: bytes.  Per (sequence, kv head) the work is G*D*2
// flops per cached token against D*2*itemsize bytes of K and V, about
// G/itemsize flops per byte (3 for G=6 in bf16), far below the ~295
// flops/byte where an H100's bf16 tensor cores would take over.  So the
// least time is the live K/V bytes over 3.35 TB/s.
//
// Design, simple and right first:
//  * One CTA per (sequence b, kv head h), 128 threads.  On the TPU the page
//    axis was a sequential grid dimension carrying (m, l, acc) in scratch;
//    CUDA blocks run in no order, so the page loop lives inside the block.
//  * Pages are walked in chunks of CHUNK=32 tokens.  The TPU held two whole
//    pages of K and V in VMEM; at the engine's default page size of 256
//    with D=128 in bf16 that ring alone is 256 KB, above the 227 KB a
//    Hopper block can have.  A 32-token f32 chunk of K and V is about
//    256*D bytes (32 KB at D=128), independent of the page size, and PS is
//    a runtime argument.  Only the valid tokens of a live page are read.
//  * K1 and K2 call ONE page-step function (page_step, below), in the same
//    page order, so K1 == (slots view, then K2) bit for bit.  page_step is
//    __noinline__ and spells out every multiply-add with __fmaf_rn, so the
//    compiler cannot contract or reorder it differently in the two kernels.
//  * Scores and sums are f32; int8 pools are dequantized in f32 with their
//    bf16 per-(token, head) scales before the dot product.
//  * At B*KH = 64 CTAs the card's 132 SMs are underfilled; splitting the
//    pages of one sequence across CTAs (and merging their partials) is left
//    for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;     // tokens per shared-memory chunk
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory of one CTA, as offsets into one float array.  K rows are
// padded to D + 1 floats: in the score loop the 32 threads of a warp read
// 32 different tokens at the same d, which with a row stride of D (a
// multiple of 32) would all hit one bank.
struct Smem {
  float* q;      // [G, D]
  float* k;      // [CHUNK, D + 1]
  float* v;      // [CHUNK, D]
  float* s;      // [G, CHUNK] scores, then probabilities
  float* acc;    // [G, D]
  float* m;      // [G]
  float* l;      // [G]
  float* alpha;  // [G]
};

__host__ __device__ inline size_t smem_floats(int G, int D) {
  return (size_t)G * D * 2 + (size_t)CHUNK * (2 * D + 1) +
         (size_t)G * CHUNK + (size_t)G * 3;
}

__device__ inline Smem carve(float* base, int G, int D) {
  Smem sm;
  sm.q = base;
  sm.k = sm.q + G * D;
  sm.v = sm.k + CHUNK * (D + 1);
  sm.s = sm.v + CHUNK * D;
  sm.acc = sm.s + G * CHUNK;
  sm.m = sm.acc + G * D;
  sm.l = sm.m + G;
  sm.alpha = sm.l + G;
  return sm;
}

// The shared per-page step: online-softmax update of (m, l, acc) with the
// first n_valid tokens of pool row `row`, kv head h.  Op order per chunk,
// as in the reference: s = (q . k) * scale; m_new = max(m, max s);
// alpha = exp(m - m_new); p = exp(s - m_new); l = l*alpha + sum p;
// acc = acc*alpha + p . v.  Tokens past n_valid are masked in the
// reference (their p is exactly 0 and adds nothing); here they are not
// read at all.
template <typename KV>
__device__ __noinline__ void page_step(
    const KV* __restrict__ kp, const KV* __restrict__ vp,
    const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, int row, int h, int n_valid,
    int PS, int KH, int G, int D, float scale, float* smem_base) {
  Smem sm = carve(smem_base, G, D);
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < n_valid; c0 += CHUNK) {
    const int nt = min(CHUNK, n_valid - c0);
    // 1. K and V chunk -> f32 shared (dequantized for int8 pools)
    for (int i = tid; i < nt * D; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      const size_t tok = (size_t)row * PS + c0 + t;
      const size_t src = (tok * KH + h) * D + d;
      float kf = to_f32(kp[src]);
      float vf = to_f32(vp[src]);
      if (ks != nullptr) {
        kf = __fmul_rn(kf, __bfloat162float(ks[tok * KH + h]));
        vf = __fmul_rn(vf, __bfloat162float(vs[tok * KH + h]));
      }
      sm.k[t * (D + 1) + d] = kf;
      sm.v[t * D + d] = vf;
    }
    __syncthreads();
    // 2. scores s[g, t] = (q[g] . k[t]) * scale
    for (int i = tid; i < G * nt; i += blockDim.x) {
      const int g = i / nt, t = i - g * nt;
      const float* qg = sm.q + g * D;
      const float* kt = sm.k + t * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = __fmaf_rn(qg[d], kt[d], dot);
      sm.s[g * CHUNK + t] = __fmul_rn(dot, scale);
    }
    __syncthreads();
    // 3. online-softmax statistics, one thread per query head
    for (int g = tid; g < G; g += blockDim.x) {
      float* sg = sm.s + g * CHUNK;
      const float m_prev = sm.m[g];
      float m_new = m_prev;
      for (int t = 0; t < nt; ++t) m_new = fmaxf(m_new, sg[t]);
      const float alpha = expf(__fsub_rn(m_prev, m_new));
      float sum = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float p = expf(__fsub_rn(sg[t], m_new));
        sg[t] = p;
        sum = __fadd_rn(sum, p);
      }
      sm.l[g] = __fmaf_rn(sm.l[g], alpha, sum);
      sm.m[g] = m_new;
      sm.alpha[g] = alpha;
    }
    __syncthreads();
    // 4. acc[g, d] = acc * alpha + p . v
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* pg = sm.s + g * CHUNK;
      float pv = 0.f;
      for (int t = 0; t < nt; ++t) pv = __fmaf_rn(pg[t], sm.v[t * D + d], pv);
      sm.acc[i] = __fmaf_rn(sm.acc[i], sm.alpha[g], pv);
    }
    __syncthreads();
  }
}

template <typename Q>
__device__ void init_state(const Q* __restrict__ q, int b, int h, int KH,
                           int G, int D, float* smem_base) {
  Smem sm = carve(smem_base, G, D);
  const size_t q0 = ((size_t)b * KH * G + (size_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    sm.q[i] = to_f32(q[q0 + i]);
    sm.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sm.m[g] = NEG_INF;
    sm.l[g] = 0.f;
  }
  __syncthreads();
}

// Normalized finish: acc * (l > 0 ? 1 / max(l, 1e-30) : 0), cast to Q.
template <typename Q>
__device__ void finish(Q* __restrict__ out, int b, int h, int KH, int G,
                       int D, float* smem_base) {
  Smem sm = carve(smem_base, G, D);
  const size_t o0 = ((size_t)b * KH * G + (size_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const float l = sm.l[i / D];
    const float norm = l > 0.f ? __fdiv_rn(1.f, fmaxf(l, 1e-30f)) : 0.f;
    store(out + o0 + i, __fmul_rn(sm.acc[i], norm));
  }
}

template <typename Q, typename KV>
__global__ void __launch_bounds__(THREADS) fused_decode_kernel(
    const Q* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ positions, int KH, int G, int D, int MP, int NP,
    int PS, float scale, int partials, Q* __restrict__ out,
    float* __restrict__ o_part, float* __restrict__ m_part,
    float* __restrict__ l_part) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  init_state(q, b, h, KH, G, D, smem);
  const int pos = positions[b];
  for (int p = 0; p < MP && p * PS <= pos; ++p) {
    const int pid = bt[(size_t)b * MP + p];
    if (pid < 0) continue;                       // absent page: not read
    const int row = min(pid, NP - 1);            // clamp: address only
    const int n_valid = min(PS, pos - p * PS + 1);
    page_step(kp, vp, ks, vs, row, h, n_valid, PS, KH, G, D, scale, smem);
  }
  if (partials) {
    Smem sm = carve(smem, G, D);
    const size_t o0 = ((size_t)b * KH + h) * G;
    for (int i = threadIdx.x; i < G * D; i += blockDim.x)
      o_part[o0 * D + i] = sm.acc[i];
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      m_part[o0 + g] = sm.m[g];
      l_part[o0 + g] = sm.l[g];
    }
  } else {
    finish(out, b, h, KH, G, D, smem);
  }
}

template <typename Q, typename KV>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const Q* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ page_ids,
    const int* __restrict__ lens, int KH, int G, int D, int MP, int NP,
    int PS, float scale, Q* __restrict__ out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  init_state(q, b, h, KH, G, D, smem);
  const int len = lens[b];
  for (int p = 0; p < MP; ++p) {
    const int pid = page_ids[(size_t)b * MP + p];
    const int base = p * PS;
    if (pid < 0 || base >= len) continue;        // no valid token: skipped
    const int row = min(pid, NP - 1);
    const int n_valid = min(PS, len - base);
    page_step(kp, vp, ks, vs, row, h, n_valid, PS, KH, G, D, scale, smem);
  }
  finish(out, b, h, KH, G, D, smem);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

template <typename Q, typename KV>
cudaError_t launch_fused(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs, const void* bt,
                         const void* pos, int B, int KH, int G, int D, int MP,
                         int NP, int PS, float scale, int partials, void* out,
                         void* o_part, void* m_part, void* l_part,
                         cudaStream_t stream) {
  const size_t smem = smem_floats(G, D) * sizeof(float);
  auto kernel = fused_decode_kernel<Q, KV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KH), THREADS, smem, stream>>>(
      (const Q*)q, (const KV*)kp, (const KV*)vp, (const __nv_bfloat16*)ks,
      (const __nv_bfloat16*)vs, (const int*)bt, (const int*)pos, KH, G, D,
      MP, NP, PS, scale, partials, (Q*)out, (float*)o_part, (float*)m_part,
      (float*)l_part);
  return cudaGetLastError();
}

template <typename Q, typename KV>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs, const void* ids,
                         const void* lens, int B, int KH, int G, int D,
                         int MP, int NP, int PS, float scale, void* out,
                         cudaStream_t stream) {
  const size_t smem = smem_floats(G, D) * sizeof(float);
  auto kernel = paged_attention_kernel<Q, KV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KH), THREADS, smem, stream>>>(
      (const Q*)q, (const KV*)kp, (const KV*)vp, (const __nv_bfloat16*)ks,
      (const __nv_bfloat16*)vs, (const int*)ids, (const int*)lens, KH, G, D,
      MP, NP, PS, scale, (Q*)out);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (kernels/_build.py)
#define DISPATCH(QT, KT, CALL)                                          \
  if (q_dtype == 0 && kv_dtype == 0) return CALL(float, float);         \
  if (q_dtype == 0 && kv_dtype == 1) return CALL(float, __nv_bfloat16); \
  if (q_dtype == 0 && kv_dtype == 2) return CALL(float, int8_t);        \
  if (q_dtype == 1 && kv_dtype == 0) return CALL(__nv_bfloat16, float); \
  if (q_dtype == 1 && kv_dtype == 1)                                    \
    return CALL(__nv_bfloat16, __nv_bfloat16);                          \
  if (q_dtype == 1 && kv_dtype == 2) return CALL(__nv_bfloat16, int8_t);\
  return (int)cudaErrorInvalidValue;

extern "C" int fused_decode_launch(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* bt, const void* pos, int B, int KH, int G,
    int D, int MP, int NP, int PS, float scale, int q_dtype, int kv_dtype,
    int partials, void* out, void* o_part, void* m_part, void* l_part,
    void* stream) {
  if (B == 0) return 0;
#define CALL_FUSED(QT, KT)                                                 \
  (int)launch_fused<QT, KT>(q, kp, vp, ks, vs, bt, pos, B, KH, G, D, MP, NP, \
                            PS, scale, partials, out, o_part, m_part, l_part,\
                            (cudaStream_t)stream)
  DISPATCH(QT, KT, CALL_FUSED)
#undef CALL_FUSED
}

extern "C" int paged_attention_launch(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* ids, const void* lens, int B, int KH, int G,
    int D, int MP, int NP, int PS, float scale, int q_dtype, int kv_dtype,
    void* out, void* stream) {
  if (B == 0) return 0;
#define CALL_PAGED(QT, KT)                                                  \
  (int)launch_paged<QT, KT>(q, kp, vp, ks, vs, ids, lens, B, KH, G, D, MP,  \
                            NP, PS, scale, out, (cudaStream_t)stream)
  DISPATCH(QT, KT, CALL_PAGED)
#undef CALL_PAGED
}
