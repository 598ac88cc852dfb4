// The online-softmax key walk shared by the flash tree-verify kernel
// (flash_verify.cu), the fused NSA verify kernel (nsa_verify.cu) and the
// routing kernel (routing.cu).
//
// A CTA of NT = 128 threads (NW = 4 warps) holds RT = 16 query rows and
// walks a list of key units of UK = 16 keys. The units are dealt to the
// warps in turn (unit u to warp u % NW), and every warp keeps its own
// online softmax over its units: no __syncthreads inside the walk. Each
// warp copies its next unit's K/V rows into its own two-stage ring in
// shared memory with 16-byte cp.async copies while it computes the current
// one (one source row per key: a gathered selected block, a paged window
// row and a dense row cost the same; f32 K/V above head dim 128 use a
// one-stage ring, see stages()). At the end the four warp states are
// merged in warp order (cta_partial) into one partial (m, l, acc) per row,
// which the kernel merges across CTAs.
//
// bf16 K/V (the served type): both products run on tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), keys on the M side so the
// 16 rows are two n8 tiles and no m16 row is padding: S^T = K Q^T, then
// O^T += V^T P^T. q (f32 by contract) and P (f32) are each split into two
// bf16 terms, hi = bf16(x) and lo = bf16(x - hi), and each product is two
// MMAs; K and V are exact in bf16, so the residual is about 2^-16 of the
// f32 value and the kernels keep the f32 tolerance of their plain
// versions. K tiles are read with ldmatrix, V tiles with ldmatrix.trans;
// the P^T fragments come out of the S^T accumulators with movmatrix.
//
// f32 K/V (float32 equality runs only): the same walk, rows and fragment
// layout, with the dots in f32 on CUDA cores (float4 reads of K and q, P
// through a per-warp scratch for the P.V sums).
//
// A CTA with at most 8 rows runs one n8 row tile (NTL = 1: half the
// registers and dots), else two. Fragment layout (mma.sync m16n8k16,
// lane = 4 g + t): the S^T accumulator of row tile n holds
// s[n][c] = S[key g + 8 (c >> 1)][row 8 n + 2 t + (c & 1)]; the O^T
// accumulator acc[md][n][c] holds
// O[row 8 n + 2 t + (c & 1)][dh 16 md + g + 8 (c >> 1)]. Running max and sum per row live in registers
// (m[n][j], l[n][j] for row 8 n + 2 t + j, equal across the 8 lanes of one
// t). A fully masked unit adds exactly 0 and leaves the running max
// unchanged.
//
// A walk may pass a hook that sees each unit's raw S^T fragment (before
// the mask and the softmax step): routing keeps its logits that way. The
// default hook does nothing and compiles away.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace online_softmax {

constexpr int NT = 128;                // threads per CTA
constexpr int NW = NT / 32;
constexpr int UK = 16;                 // keys per unit (one m16 tile)
constexpr int RT = 16;                 // query rows per CTA (two n8 tiles)
constexpr float NEG = -1e30f;          // initial running max

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max / sum over the 8 lanes of one t (the key index g of a fragment)
__device__ __forceinline__ float g_max(float v) {
  for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float g_sum(float v) {
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src == nullptr fills zeros (nothing is read
// from `dummy`, which only has to be a valid global address)
__device__ __forceinline__ void cp16(void* dst, const void* src, const void* dummy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src ? src : dummy), "r"(src ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ uint32_t movm_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d += a * b (m16n8k16, bf16 in, f32 accumulate)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- storage
// Row pitch of a K/V unit in shared memory: 16 bytes of padding, so the
// 8 row addresses of one ldmatrix phase fall in distinct banks (at every
// head dim that is a multiple of 16: 64 to 256).
template <typename KV, int DH>
constexpr int pitch() { return DH + 16 / (int)sizeof(KV); }

// Stages of a warp's K/V ring: two (the next unit's copy overlaps the
// current unit's dots), except f32 K/V above head dim 128, whose two-stage
// rings alone would take 200-266 KB of the 227 KB a CTA may hold; those
// instances (float32 equality runs only) wait for each unit's copy.
template <typename KV, int DH>
__host__ __device__ constexpr int stages() { return sizeof(KV) == 4 && DH > 128 ? 1 : 2; }

template <typename KV, int DH>
struct WarpBuf {                       // one warp's K/V ring
  KV k[stages<KV, DH>()][UK][pitch<KV, DH>()];
  KV v[stages<KV, DH>()][UK][pitch<KV, DH>()];
};

// q of the CTA's rows: bf16 hi / lo terms (tensor cores) or f32 (CUDA
// cores, with each warp's P scratch)
template <typename KV, int DH> struct QTile;
template <int DH> struct QTile<__nv_bfloat16, DH> {
  __nv_bfloat16 hi[RT][DH + 8];
  __nv_bfloat16 lo[RT][DH + 8];
  __device__ void set(int r, int d, float x) {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi[r][d] = h;
    lo[r][d] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
};
template <int DH> struct QTile<float, DH> {
  float q[RT][DH + 4];
  float p[NW][UK][RT + 1];
  __device__ void set(int r, int d, float x) { q[r][d] = x; }
};

// One warp's online-softmax state over NTL row tiles of 8 (NTL = 1 when
// the CTA holds at most 8 rows: half the registers and dots).
template <int DH, int NTL>
struct State {
  float m[NTL][2], l[NTL][2];
  float acc[DH / 16][NTL][4];
  __device__ void init() {
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) { m[n][j] = NEG; l[n][j] = 0.f; }
#pragma unroll
    for (int md = 0; md < DH / 16; ++md)
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[md][n][c] = 0.f;
  }
};

// Shared memory of the walk: the warps' rings (reused for the warp
// partials and the kernels' merge tables), q, and the warp merge.
template <typename KV, int DH>
struct Walk {
  WarpBuf<KV, DH> w[NW];
  QTile<KV, DH> q;
  float wm[NW][RT], wl[NW][RT], sc[NW][RT];
  float cm[RT], cl[RT];
  // floats of the ring region the kernels may reuse once the walk is done
  static constexpr int SCRATCH = (int)(sizeof(WarpBuf<KV, DH>) * NW / sizeof(float));
  __device__ float* scratch() { return reinterpret_cast<float*>(&w[0]); }
  // warp i's own ring as floats (RT x DH of them fit in it)
  __device__ float* warp_scratch(int i) { return reinterpret_cast<float*>(&w[i]); }
};

// The default hook of a walk: nothing.
struct NoHook {
  template <typename I, typename S>
  __device__ __forceinline__ void operator()(const I&, const S&) const {}
};

// ---------------------------------------------------------------- step
// Masks s (key kk = g + 8 (c >> 1) < nk, row r < rows, mask(r, kk)), then
// advances the running max / sum and rescales the accumulator; returns the
// probabilities in s. __expf (ex2.approx) errs by about 2^-21 relative for
// the arguments here (<= 0), far inside the kernels' rtol 2e-4.
template <int DH, int NTL, typename Mask>
__device__ __forceinline__ void softmax_step(State<DH, NTL>& st, float (&s)[NTL][4], int nk,
                                             int rows, Mask mask) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kk = g + 8 * (c >> 1), r = 8 * n + 2 * t + (c & 1);
      if (!(kk < nk && r < rows && mask(r, kk))) s[n][c] = -INFINITY;
    }
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float mt = g_max(fmaxf(s[n][j], s[n][j + 2]));
      const float m_old = st.m[n][j];
      const float m_new = fmaxf(m_old, mt);      // masked keys never raise it
      const float p0 = s[n][j] == -INFINITY ? 0.f : __expf(s[n][j] - m_new);
      const float p1 = s[n][j + 2] == -INFINITY ? 0.f : __expf(s[n][j + 2] - m_new);
      s[n][j] = p0;
      s[n][j + 2] = p1;
      const float alpha = __expf(m_old - m_new);
      st.l[n][j] = st.l[n][j] * alpha + g_sum(p0 + p1);
      st.m[n][j] = m_new;
#pragma unroll
      for (int md = 0; md < DH / 16; ++md) {
        st.acc[md][n][j] *= alpha;
        st.acc[md][n][j + 2] *= alpha;
      }
    }
}

// One unit of nk <= UK keys whose K/V rows are in k / v (shared memory);
// hook(s) sees the raw S^T fragment.
template <int DH, int NTL, typename Mask, typename Hook>
__device__ __forceinline__ void unit_step(State<DH, NTL>& st, QTile<__nv_bfloat16, DH>& q,
                                          const __nv_bfloat16 (*k)[DH + 8],
                                          const __nv_bfloat16 (*v)[DH + 8], int nk, int rows,
                                          Mask mask, Hook hook) {
  const int lane = threadIdx.x & 31;
  float s[NTL][4];
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
  // S^T = K Q^T: A = K (keys x dh), B = Q^T; q_hi then q_lo
  const int ka_row = (lane & 7) + ((lane >> 3) & 1) * 8, ka_col = (lane >> 4) * 8;
  const int qb_row = (lane & 7) + (lane >> 4) * 8, qb_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4], bh[4], bl[4];
    ldsm_x4(a, &k[ka_row][ks * 16 + ka_col]);
    ldsm_x4(bh, &q.hi[qb_row][ks * 16 + qb_col]);
    ldsm_x4(bl, &q.lo[qb_row][ks * 16 + qb_col]);
#pragma unroll
    for (int n = 0; n < NTL; ++n) {
      mma(s[n], a, bh[2 * n], bh[2 * n + 1]);
      mma(s[n], a, bl[2 * n], bl[2 * n + 1]);
    }
  }
  hook(s);
  softmax_step(st, s, nk, rows, mask);
  // P^T fragments (B operand, keys x rows): transpose the S^T accumulators
  uint32_t ph[NTL][2], pl[NTL][2];
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = s[n][2 * h], x1 = s[n][2 * h + 1];
      const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
      ph[n][h] = movm_t(pack_bf16(__bfloat162float(h0), __bfloat162float(h1)));
      pl[n][h] = movm_t(pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1)));
    }
  // O^T += V^T P^T: A = V^T (dh x keys) by ldmatrix.trans
  const int va_row = (lane & 7) + (lane >> 4) * 8, va_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int md = 0; md < DH / 16; ++md) {
    uint32_t a[4];
    ldsm_x4_t(a, &v[va_row][md * 16 + va_col]);
#pragma unroll
    for (int n = 0; n < NTL; ++n) {
      mma(st.acc[md][n], a, ph[n][0], ph[n][1]);
      mma(st.acc[md][n], a, pl[n][0], pl[n][1]);
    }
  }
}

template <int DH, int NTL, typename Mask, typename Hook>
__device__ __forceinline__ void unit_step(State<DH, NTL>& st, QTile<float, DH>& q,
                                          const float (*k)[DH + 4], const float (*v)[DH + 4],
                                          int nk, int rows, Mask mask, Hook hook) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float s[NTL][4];
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
  // unrolled twice, except above head dim 128 with two row tiles or above
  // 192: there once, which keeps the (DH / 16 x NTL x 4)-float accumulator
  // and the K / q loads in registers (ptxas spilled the other choices)
#pragma unroll(DH > 128 && (NTL == 2 || DH > 192) ? 1 : 2)
  for (int d = 0; d < DH; d += 4) {
    const float4 k0 = *reinterpret_cast<const float4*>(&k[g][d]);
    const float4 k1 = *reinterpret_cast<const float4*>(&k[g + 8][d]);
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(&q.q[8 * n + 2 * t + j][d]);
        s[n][j] += x.x * k0.x + x.y * k0.y + x.z * k0.z + x.w * k0.w;
        s[n][j + 2] += x.x * k1.x + x.y * k1.y + x.z * k1.z + x.w * k1.w;
      }
  }
  hook(s);
  softmax_step(st, s, nk, rows, mask);
  float (*p)[RT + 1] = q.p[warp];
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[g + 8 * (c >> 1)][8 * n + 2 * t + (c & 1)] = s[n][c];
  __syncwarp();
  for (int kk = 0; kk < nk; ++kk) {
    float pr[NTL][2];
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) pr[n][j] = p[kk][8 * n + 2 * t + j];
#pragma unroll
    for (int md = 0; md < DH / 16; ++md) {
      const float v0 = v[kk][16 * md + g], v1 = v[kk][16 * md + g + 8];
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          st.acc[md][n][j] += pr[n][j] * v0;
          st.acc[md][n][j + 2] += pr[n][j] * v1;
        }
    }
  }
}

// ---------------------------------------------------------------- walk
template <typename KV>
struct Rows {                          // the K and V bases of a unit's rows
  const KV* k;
  const KV* v;
};

// This warp's share of units [0, n): unit u goes to warp u % NW. info(u)
// -> what the other callables need of unit u (computed once per use);
// valid(i) -> the unit has keys (an invalid unit is neither copied nor
// computed); base(i) -> the K and V bases of the unit's rows; src(i, kk)
// -> key kk's element offset from them (-1: zeros), called once per key
// row by lane kk < UK (a paged row resolves its page there, once); nk(i)
// -> keys in the unit; mask(i, r, kk). pre() runs in every thread once the
// first unit's copies are in flight, before any unit is computed (it loads
// q into sm.q and ends with __syncthreads). hook(i, s) sees unit i's raw
// S^T fragment s[NTL][4] (default: nothing). `dummy`: any valid global
// address. Ends with every copy landed.
template <typename KV, int DH, int NTL, typename Info, typename Valid, typename Base,
          typename Src, typename NK, typename Mask, typename Pre, typename Hook = NoHook>
__device__ __forceinline__ void walk(Walk<KV, DH>& sm, State<DH, NTL>& st, int n, int rows,
                                     const KV* dummy, Info info, Valid valid, Base base,
                                     Src src, NK nk, Mask mask, Pre pre, Hook hook = Hook()) {
  constexpr int E = 16 / (int)sizeof(KV);        // elements per 16-byte copy
  constexpr int CPR = DH / E;                    // copies per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpBuf<KV, DH>& buf = sm.w[warp];
  auto next = [&](int u) {
    while (u < n && !valid(info(u))) u += NW;
    return u;
  };
  auto issue = [&](int u, int stage) {
    const auto iu = info(u);
    const Rows<KV> bs = base(iu);
    const int off = lane < UK ? src(iu, lane) : -1;
#pragma unroll
    for (int i = lane; i < UK * CPR; i += 32) {
      const int kk = i / CPR, c = (i % CPR) * E;
      const int o = __shfl_sync(0xffffffffu, off, kk);
      cp16(&buf.k[stage][kk][c], o >= 0 ? bs.k + o + c : nullptr, dummy);
      cp16(&buf.v[stage][kk][c], o >= 0 ? bs.v + o + c : nullptr, dummy);
    }
  };
  constexpr int NS = stages<KV, DH>();
  int cur = next(warp), stage = 0;
  if (cur < n) issue(cur, 0);
  cp_commit();
  pre();
  while (cur < n) {
    const int nxt = next(cur + NW);
    if constexpr (NS == 2) {
      if (nxt < n) issue(nxt, stage ^ 1);
      cp_commit();
      cp_wait_1();
    } else {
      cp_wait_all();
    }
    __syncwarp();
    const auto iu = info(cur);
    unit_step(st, sm.q, buf.k[stage], buf.v[stage], nk(iu), rows,
              [&](int r, int kk) { return mask(iu, r, kk); },
              [&](const float (&s)[NTL][4]) { hook(iu, s); });
    __syncwarp();
    if constexpr (NS == 1) {           // the ring is free again: copy the next unit
      if (nxt < n) issue(nxt, 0);
      cp_commit();
    }
    cur = nxt;
    stage = NS == 2 ? stage ^ 1 : 0;
  }
  cp_wait_all();
  __syncwarp();
}

// Merges the warps' states (in warp order) into the CTA's partial: m and l
// per row to ml (RT x 2 floats), acc (RT x DH floats, rows with l > 0) to
// pacc. Leaves cm / cl in shared memory. Ends with a __syncthreads.
template <typename KV, int DH, int NTL>
__device__ __forceinline__ void cta_partial(Walk<KV, DH>& sm, const State<DH, NTL>& st,
                                            float* __restrict__ ml,
                                            float* __restrict__ pacc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  static_assert(sizeof(WarpBuf<KV, DH>) >= sizeof(float) * RT * DH, "warp partial fits its ring");
  float* wacc = sm.warp_scratch(warp);             // this warp's ring, now free
#pragma unroll
  for (int md = 0; md < DH / 16; ++md)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wacc[(8 * n + 2 * t + (c & 1)) * DH + 16 * md + g + 8 * (c >> 1)] = st.acc[md][n][c];
  if (g == 0) {
#pragma unroll
    for (int r = 2 * t; r < RT; r += 8) {          // rows past the row tiles: empty
      sm.wm[warp][r] = sm.wm[warp][r + 1] = NEG;
      sm.wl[warp][r] = sm.wl[warp][r + 1] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sm.wm[warp][8 * n + 2 * t + j] = st.m[n][j];
        sm.wl[warp][8 * n + 2 * t + j] = st.l[n][j];
      }
  }
  __syncthreads();
  if (tid < RT) {
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (sm.wl[w][tid] > 0.f) M = fmaxf(M, sm.wm[w][tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = sm.wl[w][tid] > 0.f ? expf(sm.wm[w][tid] - M) : 0.f;
      sm.sc[w][tid] = e;
      L += sm.wl[w][tid] * e;
    }
    sm.cm[tid] = M;
    sm.cl[tid] = L;
    ml[2 * tid] = M;
    ml[2 * tid + 1] = L;
  }
  __syncthreads();
  for (int i = tid; i < RT * DH / 4; i += NT) {
    const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
    if (!(sm.cl[r] > 0.f)) continue;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = sm.sc[w][r];
      const float4 x = *reinterpret_cast<const float4*>(&sm.warp_scratch(w)[r * DH + d]);
      a.x += x.x * e; a.y += x.y * e; a.z += x.z * e; a.w += x.w * e;
    }
    *reinterpret_cast<float4*>(&pacc[r * DH + d]) = a;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- merge
// The last CTA's merge of partials. sc holds each partial's m and xl its l,
// both [x][RT]; for row r over partials [x0, x1), one warp turns sc into
// scales exp(m - M) / L over the partials with l > 0 (0 for the others and
// when no partial has l > 0). Fixed reduction order.
__device__ __forceinline__ void merge_scales(float* sc, const float* xl, int r, int x0,
                                             int x1) {
  const int lane = threadIdx.x & 31;
  float Mx = NEG;
  for (int x = x0 + lane; x < x1; x += 32)
    if (xl[x * RT + r] > 0.f) Mx = fmaxf(Mx, sc[x * RT + r]);
  Mx = warp_max(Mx);
  float L = 0.f;
  for (int x = x0 + lane; x < x1; x += 32)
    if (xl[x * RT + r] > 0.f) L += xl[x * RT + r] * expf(sc[x * RT + r] - Mx);
  L = warp_sum(L);
  __syncwarp();
  for (int x = x0 + lane; x < x1; x += 32)
    sc[x * RT + r] = xl[x * RT + r] > 0.f ? expf(sc[x * RT + r] - Mx) / L : 0.f;
}

// sum over partials x in [x0, x1), in order, of sc[x][r] * acc_x[d..d+3]
// (acc_x at acc + x * stride); partials with scale 0 are never read (they
// may be unwritten). Loads go out eight at a time before they are used.
__device__ __forceinline__ float4 merge_acc(const float* sc, int r, const float* acc,
                                            size_t stride, int x0, int x1) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int x = x0; x < x1; x += 8) {
    float s[8];
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = x + i < x1 ? sc[(x + i) * RT + r] : 0.f;
      v[i] = s[i] != 0.f ? __ldcg(reinterpret_cast<const float4*>(acc + (x + i) * stride))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s[i] != 0.f) {
        a.x += s[i] * v[i].x; a.y += s[i] * v[i].y; a.z += s[i] * v[i].z; a.w += s[i] * v[i].w;
      }
  }
  return a;
}

// Takes this CTA's ticket among `count` CTAs that share `ticket`; returns
// true in the last one (in every thread), after which the others' partials
// are visible. The last CTA resets the ticket for the next call.
__device__ __forceinline__ bool last_of(int* ticket, int count, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1) == count - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

}  // namespace online_softmax
