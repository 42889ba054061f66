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
// Bound on this card: bytes.  Per cached token and kv head the work is
// 4*G*D flops (q.k and p.v, a multiply and an add each) against 2*D*itemsize
// bytes of K and V: 6 flops per byte for G=6 in bf16, below the ~20 flops
// per byte at which the H100's f32 CUDA cores (67 TFLOP/s against
// 3.35 TB/s) would become the limit.  So the bound is the live K/V bytes
// over 3.35 TB/s, and what the kernel needs is parallelism, latency hiding
// and few instructions a token (the tensor cores below serve the last).
//
// Design (flash decoding):
//  * One kernel body for K1 and K2.  The two differ only in the per-lane
//    control value: K1 reads pos[b] and attends n = pos[b] + 1 tokens, K2
//    reads lens[b] and attends n = lens[b] (argument n_offset).  In both,
//    logical page p is live iff p < ceil(n / PS) and its row entry is >= 0,
//    and token t is valid iff t < n on a live page.  K1 == (slots view,
//    then K2) therefore holds bit for bit by construction.
//  * Grid (S, KH * HG, B).  The S splits of one (sequence, kv head) take
//    contiguous ranges of its live logical pages, computed in the kernel
//    from n (no host sync, capturable in a CUDA graph): P = ceil(n / PS),
//    pps = ceil(P / S), split s takes [s*pps, min(P, (s+1)*pps)).  A split
//    whose range is empty writes m = -1e30, l = 0 (o = 0 is implied); one
//    whose range holds only holes writes m = -1e30, l = 0, o = 0.  The
//    wrapper picks S from static shapes (paged_attention.split_count).
//    HG head groups of at most GB = 8 query heads bound the registers that
//    hold the accumulators.
//  * A second kernel merges the S partials, one thread per output element,
//    in the fixed order s = 0..S-1 (m = max m_s, w_s = exp(m_s - m),
//    l = sum w_s l_s, o = sum w_s o_s over the splits with l_s > 0), then
//    normalizes or returns (o, m, l).  No atomics: the result is the same
//    from run to run.
//  * Each split walks its range in tiles of T = 32 tokens.  A tile spans
//    pages when PS < 32 and a page spans tiles when PS > 32; each row's
//    address comes from the row entry of its own page.  The split's row
//    entries are staged in shared memory once.  K and V rows are copied in
//    their stored dtype with 16-byte cp.async into a ring of two stages,
//    the next tile in flight while this one is computed; one barrier per
//    tile.  (A third stage measured no faster: four CTAs of two stages
//    each share an SM at the serve shape.)  Only valid tokens of live pages
//    are copied.  Rows that are not a multiple of 16 bytes (e.g. int8 with
//    D = 8) are copied element by element instead, and int8 scales (2 bytes
//    each) with plain loads.  Shared rows are padded so the q.k loads are
//    free of bank conflicts.
//  * Each warp owns 8 tokens of every tile and keeps its own online softmax
//    state (m, l, acc); the four warps are merged once, at the end of the
//    split.  q.k, when q and the pools are bf16 and D % 16 == 0 (the serve
//    path): one mma.sync m16n8k16 per 16 dims, the warp's 8 K rows (from
//    ldmatrix) against the group's 8 heads of q; products of two bf16
//    values are exact and the sums f32.  Otherwise: the 4 lanes of a token
//    each take every 4th 8-element chunk of the row against q (kept in
//    shared memory in its own dtype), then a __shfl_xor butterfly over
//    those 4 lanes.  The max and sum of the softmax are __shfl_xor
//    reductions over the warp's 8 tokens, each step over all heads at
//    once.  p.v: lane j owns output columns j, j+32, ... (lanes past D
//    masked) of every head of the group.  Everything outside the mma is
//    f32, spelled with __fmaf_rn, __fadd_rn and __fmul_rn so the compiler
//    cannot contract it; exponentials are __expf.
//  * Why not 32 lanes a score on the CUDA cores: each lane would have D/32
//    products (4 at D=128) and the butterfly five shuffle-and-add levels
//    for every score.  Why the tensor cores for q.k only: p.v through
//    bf16 mma would round p to 8 bits.  Why not TMA: rows are scattered
//    256-byte pieces (one per token and kv head), which cp.async moves
//    without a tensor map per page.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LPT = 4;                  // lanes a token in q.k
constexpr int TPW = 32 / LPT;           // tokens a warp in one tile
constexpr int T = WARPS * TPW;          // tokens a tile
constexpr int GB = 8;                   // query heads a CTA at most
constexpr int NS = 2;                   // ring stages
constexpr int SMEM_MAX = 227 * 1024;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// Eight consecutive K elements of a shared-memory row, widened to f32.
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float f[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = static_cast<float>(static_cast<int8_t>((u.x >> (8 * i)) & 0xff));
    f[4 + i] =
        static_cast<float>(static_cast<int8_t>((u.y >> (8 * i)) & 0xff));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// q.k runs on the tensor cores when q and the pools are bf16: products of
// two bf16 values are exact in f32, and the sums are f32.
template <typename Q, typename KV>
struct UseMma {
  static constexpr bool value = false;
};
template <>
struct UseMma<__nv_bfloat16, __nv_bfloat16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ void ldmatrix_x4(const void* p, unsigned r[4]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Args {
  const void* q;                 // [B, KH*G, D]
  const void* k;                 // [NP, PS, KH, D]
  const void* v;
  const __nv_bfloat16* ks;       // [NP, PS, KH] or null
  const __nv_bfloat16* vs;
  const int* rows;               // [B, MP] page rows (raw bt or slots)
  const int* ctl;                // [B] positions (K1) or lengths (K2)
  int n_offset;                  // 1: ctl holds positions; 0: lengths
  int B, KH, G, D, MP, NP, PS, S, HG, RS, pps_max, aligned;
  int ps_shift;                  // log2(PS) for a power of two, else -1
  int mma;                       // q.k on the tensor cores (bf16, D%16=0)
  float scale;
  float* o_s;                    // [S, B, KH, G, D]
  float* m_s;                    // [S, B, KH, G]
  float* l_s;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Shared-memory row stride of K and V: the row rounded up to whole
// 8-element chunks, then padded so that the rows which one shared-memory
// phase of the q.k loads touches fall on distinct banks (eight rows of 16
// bytes for ldmatrix; else two rows of 64 bytes for bf16, four of 32 for
// int8, two of 128 strided for f32).
template <typename KV>
__host__ __device__ inline int row_stride(int D, bool mma) {
  const int rb = round16(((D + 7) / 8) * 8 * (int)sizeof(KV));
  const int shift = mma ? 16
                        : sizeof(KV) == 2 ? 64 : sizeof(KV) == 1 ? 32 : 16;
  return rb + ((shift - rb % 128) % 128 + 128) % 128;
}

// Shared memory: staged row entries, q in its dtype, the warps'
// probabilities, then the K/V ring and its int8 scales; after the tile
// loop the ring is reused for the merge of the four warps.
struct Layout {
  int ids, q, pw, ring, scl, merge, total;
};

__host__ __device__ inline Layout layout(int RS, int pps_max, int DJ,
                                         int qsize) {
  Layout L;
  L.ids = round16(pps_max * 4);
  L.q = round16(GB * 32 * DJ * qsize);
  L.pw = WARPS * TPW * GB * 4;
  L.ring = NS * 2 * T * RS;
  L.scl = NS * 2 * T * 4;
  L.merge = WARPS * GB * (32 * DJ + 2) * 4;
  const int body = L.ring + L.scl > L.merge ? L.ring + L.scl : L.merge;
  L.total = L.ids + L.q + L.pw + body;
  return L;
}

// Logical page of token `tok` (a shift when PS is a power of two).
__device__ __forceinline__ int page_of(const Args& a, int tok) {
  return a.ps_shift >= 0 ? tok >> a.ps_shift : tok / a.PS;
}

// Pool row of token `tok` of the split whose pages start at p0, or -1 for a
// hole.
__device__ __forceinline__ long long pool_row(const Args& a, const int* ids,
                                              int p0, int tok) {
  const int p = page_of(a, tok);
  const int pid = ids[p - p0];
  if (pid < 0) return -1;
  return (long long)min(pid, a.NP - 1) * a.PS + (tok - p * a.PS);
}

// Which 16-byte chunks of a tile's rows this thread copies: chunk ch of
// rows r0, r0 + step, ... (cpr chunks a row, step = 128 / cpr rows a
// pass; r0 = T for a thread with no chunk).
struct CopyMap {
  int ch, r0, step;
};

template <typename KV>
__device__ __forceinline__ CopyMap copy_map(const Args& a) {
  const int cpr = max(1, a.D * (int)sizeof(KV) / 16);
  CopyMap cp;
  cp.step = THREADS / cpr;
  cp.ch = threadIdx.x % cpr;
  cp.r0 = threadIdx.x < cp.step * cpr ? threadIdx.x / cpr : T;
  return cp;
}

// Copy tile `i` of the split's token range [tb, te) into ring stage `st`.
template <typename KV>
__device__ __forceinline__ void issue_tile(const Args& a, const CopyMap& cp,
                                           const int* ids,
                                           unsigned char* ring, float* scl,
                                           int p0, int tb, int te, int i,
                                           int st, int h) {
  const int RS = a.RS;
  unsigned char* kst = ring + (size_t)st * 2 * T * RS;
  unsigned char* vst = kst + (size_t)T * RS;
  const int t0 = tb + i * T;
  const KV* kp = static_cast<const KV*>(a.k);
  const KV* vp = static_cast<const KV*>(a.v);
  if (a.aligned) {
    if (cp.r0 < T) {
      const int ch = cp.ch, step = cp.step;
      for (int r = cp.r0; r < T && t0 + r < te; r += step) {
        const long long row = pool_row(a, ids, p0, t0 + r);
        if (row < 0) continue;                     // hole: not read
        const size_t off = ((size_t)row * a.KH + h) * a.D * sizeof(KV) +
                           ch * 16;
        cp_async16(kst + r * RS + ch * 16,
                   reinterpret_cast<const unsigned char*>(kp) + off);
        cp_async16(vst + r * RS + ch * 16,
                   reinterpret_cast<const unsigned char*>(vp) + off);
      }
    }
  } else {
    for (int e = threadIdx.x; e < T * a.D; e += THREADS) {
      const int r = e / a.D, d = e - r * a.D;
      if (t0 + r >= te) break;
      const long long row = pool_row(a, ids, p0, t0 + r);
      if (row < 0) continue;
      const size_t src = ((size_t)row * a.KH + h) * a.D + d;
      reinterpret_cast<KV*>(kst + r * RS)[d] = kp[src];
      reinterpret_cast<KV*>(vst + r * RS)[d] = vp[src];
    }
  }
  if (a.ks != nullptr) {
    float* s = scl + st * 2 * T;
    for (int r = threadIdx.x; r < T; r += THREADS) {
      if (t0 + r >= te) break;
      const long long row = pool_row(a, ids, p0, t0 + r);
      if (row < 0) continue;
      s[r] = __bfloat162float(a.ks[(size_t)row * a.KH + h]);
      s[T + r] = __bfloat162float(a.vs[(size_t)row * a.KH + h]);
    }
  }
}

template <typename Q, typename KV, int DJ>
__global__ void __launch_bounds__(THREADS, 4)
    split_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int h = blockIdx.y / a.HG;
  const int g0 = (blockIdx.y - h * a.HG) * GB;
  const int b = blockIdx.z;
  const int Gc = min(GB, a.G - g0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int grp = lane / LPT, sub = lane % LPT;   // token of the warp, part

  // this split's range of live logical pages, from n alone
  const int n = max(0, min(a.ctl[b] + a.n_offset, a.MP * a.PS));
  const int P = (n + a.PS - 1) / a.PS;
  const int pps = (P + a.S - 1) / a.S;
  const int p0 = s * pps, p1 = min(P, p0 + pps);
  const size_t part = ((size_t)(s * a.B + b) * a.KH + h) * a.G + g0;
  if (p0 >= p1) {              // empty split: o = 0 is implied by l = 0
    for (int g = threadIdx.x; g < Gc; g += THREADS) {
      a.m_s[part + g] = NEG_INF;
      a.l_s[part + g] = 0.f;
    }
    return;
  }

  const Layout L = layout(a.RS, a.pps_max, DJ, sizeof(Q));
  int* ids = reinterpret_cast<int*>(smem);
  Q* qs = reinterpret_cast<Q*>(smem + L.ids);                  // [GB][32DJ]
  float* pw = reinterpret_cast<float*>(smem + L.ids + L.q);    // [W][TPW][GB]
  unsigned char* ring = smem + L.ids + L.q + L.pw;
  float* scl = reinterpret_cast<float*>(ring + L.ring);
  for (int i = threadIdx.x; i < p1 - p0; i += THREADS)
    ids[i] = a.rows[(size_t)b * a.MP + p0 + i];
  const Q* qp = static_cast<const Q*>(a.q) +
                ((size_t)b * a.KH * a.G + (size_t)h * a.G + g0) * a.D;
  for (int e = threadIdx.x; e < GB * 32 * DJ; e += THREADS) {
    const int g = e / (32 * DJ), d = e - g * 32 * DJ;
    qs[e] = (g < Gc && d < a.D) ? qp[g * a.D + d] : Q(0.f);
  }
  // the pads of every ring row stay zero (q.k reads whole 8-element
  // chunks), and rows never copied hold zeros
  for (int i = threadIdx.x * 16; i < L.ring + L.scl; i += THREADS * 16)
    *reinterpret_cast<uint4*>(ring + i) = make_uint4(0, 0, 0, 0);
  float m_w[GB], l_w[GB], acc[GB][DJ];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m_w[g] = NEG_INF;
    l_w[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[g][j] = 0.f;
  }
  __syncthreads();                                  // ids, q, zeros
  // tensor-core path: q^T of the group's 8 heads as mma B fragments
  // (lane holds head lane/4, dims 2*(lane%4) + {0, 1} and + {8, 9})
  constexpr bool MMA = UseMma<Q, KV>::value;
  unsigned qb[MMA ? 2 * DJ : 1][2];
  if constexpr (MMA) {
    const Q* qrow = qs + (lane >> 2) * 32 * DJ + 2 * (lane & 3);
#pragma unroll
    for (int ks = 0; ks < 2 * DJ; ++ks) {
      qb[ks][0] = *reinterpret_cast<const unsigned*>(qrow + 16 * ks);
      qb[ks][1] = *reinterpret_cast<const unsigned*>(qrow + 16 * ks + 8);
    }
  }

  const int RS = a.RS;
  const int NC = (a.D + 7) / 8;                     // 8-element chunks
  const int tb = p0 * a.PS, te = min(p1 * a.PS, n);
  const int ntiles = (te - tb + T - 1) / T;
  const CopyMap cp = copy_map<KV>(a);
  issue_tile<KV>(a, cp, ids, ring, scl, p0, tb, te, 0, 0, h);
  cp_async_commit();
  float* pwarp = pw + w * TPW * GB;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();                  // tile i has landed, i - 1 is done
    if (i + 1 < ntiles) {
      issue_tile<KV>(a, cp, ids, ring, scl, p0, tb, te, i + 1, (i + 1) % NS,
                     h);
      cp_async_commit();
    }

    const int st = i % NS;
    const unsigned char* kst = ring + (size_t)st * 2 * T * RS;
    const unsigned char* vst = kst + (size_t)T * RS;
    const float* sc = scl + st * 2 * T;
    const int r = w * TPW + grp;                    // this lane's token
    const int tok = tb + i * T + r;
    const bool val = tok < te && ids[page_of(a, tok) - p0] >= 0;
    const unsigned vmask = __ballot_sync(FULL, val && sub == 0);
    if (vmask == 0) continue;                       // holes only

    // q.k.  Rows of invalid tokens hold zeros or an earlier tile's data:
    // their scores are masked below.
    float x[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) x[g] = 0.f;
    if (MMA && a.mma) {
      // the warp's 8 tokens as the rows of a 16x16 A tile (rows 8-15
      // repeat 0-7), D/16 mma steps; lane holds the scores of token lane/4
      // for heads 2*(lane%4) + {0, 1}, then gathers its token's 8 heads
      if constexpr (MMA) {
        const unsigned char* arow =
            kst + (w * TPW + (lane & 7)) * RS + ((lane >> 4) & 1) * 16;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2 * DJ; ++ks) {
          if (16 * ks >= a.D) break;
          unsigned af[4];
          ldmatrix_x4(arow + 32 * ks, af);
          mma_bf16(c, af, qb[ks]);
        }
#pragma unroll
        for (int g = 0; g < GB; ++g)
          x[g] = __shfl_sync(FULL, (g & 1) ? c[1] : c[0],
                             (lane & ~3) | (g >> 1));
      }
    } else {
      // the LPT lanes of a token each take every LPT-th chunk, then a
      // __shfl_xor butterfly over those lanes
      const KV* kr = reinterpret_cast<const KV*>(kst + r * RS);
#pragma unroll
      for (int c4 = 0; c4 < DJ; ++c4) {
        const int c = sub + LPT * c4;
        if (c >= NC) break;
        float kf[8];
        load8(kr + c * 8, kf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float qf[8];
          load8(qs + g * 32 * DJ + c * 8, qf);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[g] = __fmaf_rn(qf[e], kf[e], x[g]);
        }
      }
#pragma unroll
      for (int off = 1; off < LPT; off <<= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          x[g] = __fadd_rn(x[g], __shfl_xor_sync(FULL, x[g], off));
    }
    // Online softmax over the warp's tokens.  Each step of a reduction
    // runs over all GB heads at once, with no branch, so the heads'
    // shuffles overlap (heads past G have q = 0 and are never stored).
    const float ksc = a.ks != nullptr && val ? sc[r] : 1.f;
    const float vsc = a.ks != nullptr && val ? sc[T + r] : 1.f;
    float sv[GB], mt[GB], ps[GB], alpha[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      sv[g] = a.ks != nullptr ? __fmul_rn(__fmul_rn(x[g], ksc), a.scale)
                              : __fmul_rn(x[g], a.scale);
      mt[g] = val ? sv[g] : NEG_INF;
    }
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        mt[g] = fmaxf(mt[g], __shfl_xor_sync(FULL, mt[g], off));
    __syncwarp();                         // the last tile's p are read
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mx = fmaxf(m_w[g], mt[g]);
      alpha[g] = __expf(__fsub_rn(m_w[g], mx));
      ps[g] = val ? __expf(__fsub_rn(sv[g], mx)) : 0.f;
      m_w[g] = mx;
      if (sub == 0) pwarp[grp * GB + g] = __fmul_rn(ps[g], vsc);
    }
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        ps[g] = __fadd_rn(ps[g], __shfl_xor_sync(FULL, ps[g], off));
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      l_w[g] = __fmaf_rn(l_w[g], alpha[g], ps[g]);
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[g][j] = __fmul_rn(acc[g][j], alpha[g]);
    }
    __syncwarp();
    // p.v: lane owns columns lane + 32 j of every head of the group.  An
    // invalid token's p is 0 (its row holds zeros or earlier data).
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      const KV* vr = reinterpret_cast<const KV*>(vst + (w * TPW + t) * RS);
      const float4* pt = reinterpret_cast<const float4*>(pwarp + t * GB);
      const float4 pa = pt[0], pb = pt[1];
      const float pg[GB] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = lane + 32 * j;
        const float vv = d < a.D ? to_f32(vr[d]) : 0.f;
#pragma unroll
        for (int g = 0; g < GB; ++g)
          acc[g][j] = __fmaf_rn(pg[g], vv, acc[g][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                  // the ring is free

  // merge the four warps, in the order w = 0..3
  const int DP = 32 * DJ;
  float* mrg = reinterpret_cast<float*>(ring);      // [WARPS][GB][DP + 2]
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float* row = mrg + (w * GB + g) * (DP + 2);
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[lane + 32 * j] = acc[g][j];
    if (lane == 0) {
      row[DP] = m_w[g];
      row[DP + 1] = l_w[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Gc * a.D; e += THREADS) {
    const int g = e / a.D, d = e - g * a.D;
    float mx = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww)
      mx = fmaxf(mx, mrg[(ww * GB + g) * (DP + 2) + DP]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float* row = mrg + (ww * GB + g) * (DP + 2);
      const float wt = __expf(__fsub_rn(row[DP], mx));
      o = __fmaf_rn(wt, row[d], o);
      l = __fmaf_rn(wt, row[DP + 1], l);
    }
    a.o_s[(part + g) * a.D + d] = o;
    if (d == 0) {
      a.m_s[part + g] = mx;
      a.l_s[part + g] = l;
    }
  }
}

// Merge of the S split partials, one thread per output element, in the
// order s = 0..S-1; normalized output (q's dtype) or the f32 (o, m, l).
// A split with l = 0 has o = 0 and is not read (empty splits write no o).
template <typename Q>
__global__ void __launch_bounds__(THREADS) merge_splits_kernel(
    const float* __restrict__ o_s, const float* __restrict__ m_s,
    const float* __restrict__ l_s, int S, int BKH, int G, int D,
    int partials, Q* __restrict__ out, float* __restrict__ o,
    float* __restrict__ m, float* __restrict__ l) {
  const size_t stride = (size_t)BKH * G;            // one split's heads
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= stride * D) return;
  const size_t hd = e / D;
  const int d = (int)(e - hd * D);
  float mx = m_s[hd];
  for (int s = 1; s < S; ++s) mx = fmaxf(mx, m_s[s * stride + hd]);
  float os = 0.f, ls = 0.f;
  for (int s = 0; s < S; ++s) {
    const float wt = __expf(__fsub_rn(m_s[s * stride + hd], mx));
    const float ln = l_s[s * stride + hd];
    if (ln > 0.f) os = __fmaf_rn(wt, o_s[(s * stride + hd) * D + d], os);
    ls = __fmaf_rn(wt, ln, ls);
  }
  if (partials) {
    o[e] = os;
    if (d == 0) {
      m[hd] = mx;
      l[hd] = ls;
    }
  } else {
    const float norm = ls > 0.f ? __fdiv_rn(1.f, fmaxf(ls, 1e-30f)) : 0.f;
    store(out + e, __fmul_rn(os, norm));
  }
}

template <typename Q, typename KV, int DJ>
cudaError_t launch(Args a, int partials, void* out, void* o, void* m,
                   void* l, cudaStream_t stream) {
  a.mma = UseMma<Q, KV>::value && a.D % 16 == 0;
  a.RS = row_stride<KV>(a.D, a.mma);
  a.aligned = (a.D * (int)sizeof(KV)) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  a.HG = (a.G + GB - 1) / GB;
  a.ps_shift = -1;
  for (int k = 0; k < 31; ++k)
    if ((1 << k) == a.PS) a.ps_shift = k;
  a.pps_max = (a.MP + a.S - 1) / a.S;
  const Layout L = layout(a.RS, a.pps_max, DJ, sizeof(Q));
  if (L.total > SMEM_MAX || a.KH * a.HG > 65535 || a.B > 65535)
    return cudaErrorInvalidValue;
  auto kernel = split_decode_kernel<Q, KV, DJ>;
  static int allowed = 48 * 1024;         // dynamic smem this kernel may use
  cudaError_t err;
  if (L.total > allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    allowed = L.total;
  }
  kernel<<<dim3(a.S, a.KH * a.HG, a.B), THREADS, L.total, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)a.B * a.KH * a.G * a.D;
  merge_splits_kernel<Q><<<(unsigned)((elems + THREADS - 1) / THREADS),
                           THREADS, 0, stream>>>(
      a.o_s, a.m_s, a.l_s, a.S, a.B * a.KH, a.G, a.D, partials, (Q*)out,
      (float*)o, (float*)m, (float*)l);
  return cudaGetLastError();
}

template <typename Q, typename KV>
cudaError_t launch_dj(const Args& a, int partials, void* out, void* o,
                      void* m, void* l, cudaStream_t st) {
  if (a.D <= 32) return launch<Q, KV, 1>(a, partials, out, o, m, l, st);
  if (a.D <= 64) return launch<Q, KV, 2>(a, partials, out, o, m, l, st);
  if (a.D <= 128) return launch<Q, KV, 4>(a, partials, out, o, m, l, st);
  if (a.D <= 256) return launch<Q, KV, 8>(a, partials, out, o, m, l, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// One entry for K1 (n_offset 1, ctl = positions, rows = raw block table)
// and K2 (n_offset 0, ctl = lengths, rows = page ids).  `scratch` holds
// S*B*KH*G*(D+2) floats: the split partials o_s, then m_s, then l_s.
// dtype codes: 0 float32, 1 bfloat16, 2 int8 (kernels/_build.py).
extern "C" int decode_attention_launch(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* rows, const void* ctl, int n_offset, int B,
    int KH, int G, int D, int MP, int NP, int PS, int S, float scale,
    int q_dtype, int kv_dtype, int partials, void* scratch, void* out,
    void* o, void* m, void* l, void* stream) {
  if (B == 0) return 0;
  if (S < 1 || G < 1 || D < 1 || PS < 1 || MP < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = kp; a.v = vp;
  a.ks = (const __nv_bfloat16*)ks; a.vs = (const __nv_bfloat16*)vs;
  a.rows = (const int*)rows; a.ctl = (const int*)ctl; a.n_offset = n_offset;
  a.B = B; a.KH = KH; a.G = G; a.D = D; a.MP = MP; a.NP = NP; a.PS = PS;
  a.S = S; a.scale = scale;
  const size_t heads = (size_t)S * B * KH * G;
  a.o_s = (float*)scratch;
  a.m_s = a.o_s + heads * D;
  a.l_s = a.m_s + heads;
  cudaStream_t st = (cudaStream_t)stream;
#define CALL(QT, KT) \
  (int)launch_dj<QT, KT>(a, partials, out, o, m, l, st)
  if (q_dtype == 0 && kv_dtype == 0) return CALL(float, float);
  if (q_dtype == 0 && kv_dtype == 1) return CALL(float, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) return CALL(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 0) return CALL(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) return CALL(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 2) return CALL(__nv_bfloat16, int8_t);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
