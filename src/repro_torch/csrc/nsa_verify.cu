// Fused grouped-query NSA verification kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/nsa_verify/kernel.py:57
// (make_kernel) + :156 (build_verify_call), driven by
// src/repro/kernels/nsa_verify/ops.py:90 (nsa_verify_fused) and
// ops.py:228 (nsa_verify_kernel_layer). Both served variants are one
// kernel: full fusion (include_cmp = 1, reuse layers: cmp + slc + win) and
// partial fusion (include_cmp = 0, refresh layers: slc + win, with o_cmp
// read from the routing kernel's output).
//
// One CTA per (query group g of C adjacent tree queries, kv head h, batch
// b) holds the group's R = C*Gq query rows and walks a work list of key
// tiles: visible cmp blocks -> merged selected blocks -> trailing window
// of the prefix -> draft tokens. Each branch keeps a private online-
// softmax state (running max and sum per row in shared memory, the output
// accumulator in registers); the last step applies the learned gates and
// writes each real query row once. Masks are the TPU kernel's: cmp
// visibility and ncb_valid; slc ownership, prefix and causality; window
// prefix/window/causality; draft tree mask (with window distance, built
// by the wrapper). Tiles that no row can see are skipped: a fully masked
// tile adds exactly 0 and leaves the running max unchanged.
//
// The per-row scalars prefix_len, ncb_valid and win_start arrive as device
// int32 tensors of shape (B,), so a layer never waits on the host. The
// merged schedule and the ownership masks are built in PyTorch around the
// launch, as the JAX package builds them in jnp.
//
// Bound on this card: operations. The flops are 4*DH per visible (query
// row, key) pair at the f32 rate (CUDA cores). The bytes the function must
// move are the union of the selected blocks per head plus the window, cmp
// and draft K/V of each head, each read once; at the full-width ssv-nsa-1b
// shapes (bf16 K/V, prefix 4096, T=31) they take about half the time of
// the flops, so bytes come second. This first version
// is FMA on CUDA cores with f32 accumulation; the grid is G*Hkv*B CTAs
// (128 for exact C=2 at B=1, against 132 SMs); wgmma, TMA and a split of
// the work list across CTAs are left for a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int DH = 64;
constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int RMAX = 16;               // C * Gq rows per CTA
constexpr int TK = 64;                 // keys per tile
constexpr int OUT_PER_T = RMAX * DH / NT;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Smem {
  float q[RMAX][DH];
  float k[TK][DH + 1];                 // +1: conflict-free row-wise dots
  float v[TK][DH];
  float s[RMAX][TK];                   // logits, then probabilities
  float m[3][RMAX];
  float l[3][RMAX];
  float alpha[RMAX];
  int pos[RMAX];
  int qi[RMAX];
  int c_of[RMAX];
};

// One key tile of branch BR. key_ptr(k) -> pointer offset of key k's K/V
// row or -1 (zero fill); mask(r, k) -> row r may attend key k.
template <int BR, typename KV, typename KeyOff, typename Mask>
__device__ __forceinline__ void tile(Smem& sm, float (&acc)[3][OUT_PER_T],
                                     const KV* __restrict__ kbase,
                                     const KV* __restrict__ vbase, int nk,
                                     int R, KeyOff key_off, Mask mask) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();                     // previous tile's smem reads are done
  for (int i = tid; i < TK * DH; i += NT) {
    const int kk = i / DH, d = i % DH;
    const long off = kk < nk ? key_off(kk) : -1;
    sm.k[kk][d] = off >= 0 ? ld(kbase + off + d) : 0.f;
    sm.v[kk][d] = off >= 0 ? ld(vbase + off + d) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < R * TK; i += NT) {
    const int r = i / TK, kk = i % TK;
    float s = -INFINITY;
    if (kk < nk && mask(r, kk)) {
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) a += sm.q[r][d] * sm.k[kk][d];
      s = a;
    }
    sm.s[r][kk] = s;
  }
  __syncthreads();
  for (int r = warp; r < R; r += NW) {
    const float s0 = sm.s[r][lane], s1 = sm.s[r][lane + 32];
    const float mt = warp_max(fmaxf(s0, s1));
    const float m_old = sm.m[BR][r];
    const float m_new = fmaxf(m_old, mt);      // masked keys never raise it
    const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
    const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
    sm.s[r][lane] = p0;
    sm.s[r][lane + 32] = p1;
    const float psum = warp_sum(p0 + p1);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      sm.alpha[r] = alpha;
      sm.l[BR][r] = sm.l[BR][r] * alpha + psum;
      sm.m[BR][r] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OUT_PER_T; ++j) {
    const int i = tid + j * NT;
    const int r = i / DH, d = i % DH;
    if (r < R) {
      float a = acc[BR][j] * sm.alpha[r];
      for (int kk = 0; kk < nk; ++kk) a += sm.s[r][kk] * sm.v[kk][d];
      acc[BR][j] = a;
    }
  }
}

template <typename KV>
__global__ void __launch_bounds__(NT) nsa_verify_kernel(
    const float* __restrict__ q,          // (B,T,Hq,DH) pre-scaled
    const KV* __restrict__ kcache, const KV* __restrict__ vcache,  // (B,S,Hkv,DH)
    const KV* __restrict__ kcmp, const KV* __restrict__ vcmp,      // (B,NCB,Hkv,DH)
    const KV* __restrict__ kdr, const KV* __restrict__ vdr,        // (B,T,Hkv,DH)
    const int* __restrict__ merged,       // (B,G,Hkv,M), -1 = none
    const int* __restrict__ mvalid,       // (B,G,Hkv,M)
    const int* __restrict__ own,          // (B,G,Hkv,C,M)
    const int* __restrict__ qmap,         // (G,C)
    const int* __restrict__ pos,          // (B,T)
    const int* __restrict__ prefix_len,   // (B,)
    const int* __restrict__ ncb_valid,    // (B,)
    const int* __restrict__ win_start,    // (B,)
    const int* __restrict__ dmask,        // (B,T,T)
    const float* __restrict__ gates,      // (B,T,3,Hq)
    const float* __restrict__ ocmp_in,    // (B,T,Hq,DH) or null
    float* __restrict__ out,              // (B,T,Hq,DH)
    int T, int S, int Hkv, int Gq, int C, int G, int M, int NCB, int W,
    int sel_block, int cmp_block, int cmp_stride, int window,
    int include_cmp) {
  __shared__ Smem sm;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int R = C * Gq, Hq = Hkv * Gq;
  const int plen = prefix_len[b], ncbv = ncb_valid[b], ws = win_start[b];

  for (int r = tid; r < R; r += NT) {
    const int c = r / Gq;
    const int qi = qmap[g * C + c];
    sm.qi[r] = qi;
    sm.c_of[r] = c;
    sm.pos[r] = pos[b * T + qi];
    for (int br = 0; br < 3; ++br) { sm.m[br][r] = NEG; sm.l[br][r] = 0.f; }
  }
  __syncthreads();
  for (int i = tid; i < R * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int head = h * Gq + r % Gq;
    sm.q[r][d] = q[(((size_t)b * T + sm.qi[r]) * Hq + head) * DH + d];
  }
  int max_pos = 0;
  for (int r = 0; r < R; ++r) max_pos = max(max_pos, sm.pos[r]);

  float acc[3][OUT_PER_T];
#pragma unroll
  for (int br = 0; br < 3; ++br)
#pragma unroll
    for (int j = 0; j < OUT_PER_T; ++j) acc[br][j] = 0.f;

  const size_t kv_row = (size_t)Hkv * DH;

  // ---- cmp branch: visible blocks form a prefix bounded by the deepest row
  if (include_cmp) {
    int nv = (max_pos - cmp_block + 1 >= 0) ? (max_pos - cmp_block + 1) / cmp_stride + 1 : 0;
    nv = max(0, min(nv, min(ncbv, NCB)));
    const KV* kb = kcmp + (size_t)b * NCB * kv_row + (size_t)h * DH;
    const KV* vb = vcmp + (size_t)b * NCB * kv_row + (size_t)h * DH;
    for (int t0 = 0; t0 < nv; t0 += TK) {
      tile<0>(sm, acc, kb, vb, min(TK, nv - t0), R,
              [&](int kk) -> long { return (long)(t0 + kk) * (long)kv_row; },
              [&](int r, int kk) {
                const int n = t0 + kk;
                return n < ncbv && n * cmp_stride + cmp_block - 1 <= sm.pos[r];
              });
    }
  }

  // ---- slc branch over the group's merged selected blocks
  {
    const KV* kb = kcache + (size_t)b * S * kv_row + (size_t)h * DH;
    const KV* vb = vcache + (size_t)b * S * kv_row + (size_t)h * DH;
    const size_t gh = ((size_t)b * G + g) * Hkv + h;
    for (int mi = 0; mi < M; ++mi) {
      const int blk = merged[gh * M + mi];
      if (blk < 0 || mvalid[gh * M + mi] == 0 || blk * sel_block >= plen) continue;
      const int* own_m = own + gh * (size_t)C * M + mi;     // own_m[c*M]
      for (int o0 = 0; o0 < sel_block; o0 += TK) {
        const int tok0 = blk * sel_block + o0;
        if (tok0 >= plen) break;
        tile<1>(sm, acc, kb, vb, min(TK, sel_block - o0), R,
                [&](int kk) -> long {
                  const int tok = tok0 + kk;
                  return tok < S ? (long)tok * (long)kv_row : -1L;
                },
                [&](int r, int kk) {
                  const int tok = tok0 + kk;
                  return tok < plen && tok <= sm.pos[r] && own_m[sm.c_of[r] * M] > 0;
                });
      }
    }
  }

  // ---- win branch: trailing window of the prefix, then the draft tokens
  {
    const KV* kb = kcache + (size_t)b * S * kv_row + (size_t)h * DH;
    const KV* vb = vcache + (size_t)b * S * kv_row + (size_t)h * DH;
    for (int t0 = 0; t0 < W; t0 += TK) {
      const int kp0 = ws + t0;
      if (kp0 >= plen) break;
      tile<2>(sm, acc, kb, vb, min(TK, W - t0), R,
              [&](int kk) -> long {
                const int kp = kp0 + kk;
                return kp < S ? (long)kp * (long)kv_row : -1L;
              },
              [&](int r, int kk) {
                const int kp = kp0 + kk;
                return kp < plen && kp > sm.pos[r] - window && kp <= sm.pos[r];
              });
    }
    const KV* kd = kdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const KV* vd = vdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const int* dm = dmask + (size_t)b * T * T;
    for (int t0 = 0; t0 < T; t0 += TK) {
      tile<2>(sm, acc, kd, vd, min(TK, T - t0), R,
              [&](int kk) -> long { return (long)(t0 + kk) * (long)kv_row; },
              [&](int r, int kk) { return dm[(size_t)sm.qi[r] * T + t0 + kk] > 0; });
    }
  }

  // ---- gated combine, one write per real query row
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OUT_PER_T; ++j) {
    const int i = tid + j * NT;
    const int r = i / DH, d = i % DH;
    if (r >= R) continue;
    const int c = sm.c_of[r];
    if (g * C + c >= T) continue;       // padded replica of the last query
    const int qi = sm.qi[r];
    const int head = h * Gq + r % Gq;
    float o[3];
#pragma unroll
    for (int br = 0; br < 3; ++br) {
      const float l = sm.l[br][r];
      o[br] = l > 0.f ? acc[br][j] / fmaxf(l, 1e-30f) : 0.f;
    }
    const size_t row = ((size_t)b * T + qi) * Hq + head;
    const float* gt = gates + ((size_t)b * T + qi) * 3 * Hq;
    const float o_cmp = include_cmp ? o[0] : ocmp_in[row * DH + d];
    out[row * DH + d] = gt[head] * o_cmp + gt[Hq + head] * o[1] + gt[2 * Hq + head] * o[2];
  }
}

template <typename KV>
int launch(const void* const* p, const int* n, cudaStream_t stream) {
  // n: B, T, S, Hkv, Gq, C, G, M, NCB, W, sel_block, cmp_block, cmp_stride,
  //    window, include_cmp
  dim3 grid(n[6], n[3], n[0]);
  nsa_verify_kernel<KV><<<grid, NT, 0, stream>>>(
      (const float*)p[0], (const KV*)p[1], (const KV*)p[2], (const KV*)p[3],
      (const KV*)p[4], (const KV*)p[5], (const KV*)p[6], (const int*)p[7],
      (const int*)p[8], (const int*)p[9], (const int*)p[10], (const int*)p[11],
      (const int*)p[12], (const int*)p[13], (const int*)p[14], (const int*)p[15],
      (const float*)p[16], (const float*)p[17], (float*)p[18],
      n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8], n[9], n[10], n[11],
      n[12], n[13], n[14]);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged, mvalid,
//       own, qmap, positions, prefix_len, ncb_valid, win_start, dmask,
//       gates, o_cmp_in (may be null), out            (19 pointers)
// ints: B, T, S, Hkv, Gq, C, G, M, NCB, W, sel_block, cmp_block,
//       cmp_stride, window, include_cmp               (15 ints)
// kv_dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int nsa_verify_launch(const void* const* ptrs, const int* ints,
                                 int kv_dtype, void* stream) {
  const int Gq = ints[4], C = ints[5];
  if (C * Gq < 1 || C * Gq > RMAX) return (int)cudaErrorInvalidValue;
  if (!ints[14] && ptrs[17] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == 0) return launch<float>(ptrs, ints, s);
  if (kv_dtype == 1) return launch<__nv_bfloat16>(ptrs, ints, s);
  return (int)cudaErrorInvalidValue;
}
