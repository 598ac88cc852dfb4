// Fused grouped-query NSA verification kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/nsa_verify/kernel.py:57
// (make_kernel) + :156 (build_verify_call), driven by
// src/repro/kernels/nsa_verify/ops.py:90 (nsa_verify_fused) and
// ops.py:228 (nsa_verify_kernel_layer). Both served variants are one
// kernel: full fusion (include_cmp = 1, reuse layers: cmp + slc + win) and
// partial fusion (include_cmp = 0, refresh layers: slc + win, with o_cmp
// read from the routing kernel's output). The branch-wise vanilla mode
// (combine=False, driven by ops.py:286 nsa_verify_vanilla_layer) is the
// same kernel with branch = 1 (slc only) or 2 (win + draft only): one
// branch is walked and written without gates, the Fig. 6(a) baseline.
// Head dim 64 and 128 are template instances.
//
// Paged mode (the TPU kernel's paged=True, kernel.py:193-210 with the page
// table as its sixth scalar-prefetch operand, :236): with a non-null page
// table the K/V cache is the shared pool (P, ps, Hkv, DH) and token tok of
// row b lives at pool row pages[b*MP + tok/ps]*ps + tok%ps (-1 entries and
// ids past the pool read zeros). A merged selected block never straddles a
// page (ps % sel_block == 0), so it resolves once per block and its tile
// loads stay 16-byte rows; a window tile may straddle pages, so each of
// its key rows resolves on its own. An unmapped page inside the window
// reads zeros that still pass the position mask (the JAX paged window);
// merged blocks on unmapped pages arrive with mvalid cleared. Paging is a
// runtime null check, not a template flag: the branch is uniform across
// the CTA, and a flag would double the instances and the build time. The
// pool is read in place, never copied per row; the grid is unchanged.
//
// One CTA per (query group g of C adjacent tree queries, kv head h, batch
// b) holds the group's R = C*Gq query rows and walks a work list of key
// tiles: visible cmp blocks -> merged selected blocks -> trailing window
// of the prefix -> draft tokens. Each branch keeps a private online-
// softmax state (running max and sum per row in shared memory, the output
// accumulator in registers; the tile step, with its 16-byte K/V loads, is
// online_softmax.cuh, shared with flash_verify.cu); the last step applies
// the learned gates and writes each real query row once. Masks are the
// TPU kernel's: cmp visibility and ncb_valid; slc ownership, prefix and
// causality; window prefix/window/causality; draft tree mask (with window
// distance, built by the wrapper). Tiles that no row can see are skipped: a fully masked
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
// the work list across CTAs are left for a later change. Shared memory is
// dynamic (41,856 B at DH 64, 78,720 B at DH 128, over the 48 KB static
// limit, so the launch opts in).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "online_softmax.cuh"

namespace {

using namespace online_softmax;

constexpr int RMAX = 16;               // C * Gq rows per CTA

template <int DH>
struct Smem {
  Tile<RMAX, DH> t;                    // q, K/V tile, logits
  float m[3][RMAX];                    // per branch: cmp, slc, win + draft
  float l[3][RMAX];
  int pos[RMAX];
  int qi[RMAX];
  int c_of[RMAX];
};

template <typename KV, int DH>
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
    const int* __restrict__ pages,        // (B,MP) page table, or null (dense)
    int T, int S, int Hkv, int Gq, int C, int G, int M, int NCB, int W,
    int sel_block, int cmp_block, int cmp_stride, int window,
    int include_cmp, int branch, int ps, int MP, int P) {
  constexpr int OUT_PER_T = RMAX * DH / NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
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
    sm.t.q[r][d] = q[(((size_t)b * T + sm.qi[r]) * Hq + head) * DH + d];
  }
  int max_pos = 0;
  for (int r = 0; r < R; ++r) max_pos = max(max_pos, sm.pos[r]);

  float acc[3][OUT_PER_T];
#pragma unroll
  for (int br = 0; br < 3; ++br)
#pragma unroll
    for (int j = 0; j < OUT_PER_T; ++j) acc[br][j] = 0.f;

  const size_t kv_row = (size_t)Hkv * DH;
  // K/V base of this (row, head): the row's own cache, or the shared pool
  const size_t kv_base = (pages ? 0 : (size_t)b * S * kv_row) + (size_t)h * DH;
  const int* prow = pages ? pages + (size_t)b * MP : nullptr;
  // element offset of position tok's K/V row from kv_base, -1 = zeros
  auto token_off = [&](int tok) -> long {
    if (tok < 0 || tok >= S) return -1L;
    if (!prow) return (long)tok * (long)kv_row;
    const int phys = prow[tok / ps];
    if (phys < 0 || phys >= P) return -1L;
    return ((long)phys * ps + tok % ps) * (long)kv_row;
  };

  // ---- cmp branch: visible blocks form a prefix bounded by the deepest row
  if (include_cmp) {
    int nv = (max_pos - cmp_block + 1 >= 0) ? (max_pos - cmp_block + 1) / cmp_stride + 1 : 0;
    nv = max(0, min(nv, min(ncbv, NCB)));
    const KV* kb = kcmp + (size_t)b * NCB * kv_row + (size_t)h * DH;
    const KV* vb = vcmp + (size_t)b * NCB * kv_row + (size_t)h * DH;
    for (int t0 = 0; t0 < nv; t0 += TK) {
      tile(sm.t, sm.m[0], sm.l[0], acc[0], kb, vb, min(TK, nv - t0), R,
              [&](int kk) -> long { return (long)(t0 + kk) * (long)kv_row; },
              [&](int r, int kk) {
                const int n = t0 + kk;
                return n < ncbv && n * cmp_stride + cmp_block - 1 <= sm.pos[r];
              });
    }
  }

  // ---- slc branch over the group's merged selected blocks
  if (branch != 2) {
    const KV* kb = kcache + kv_base;
    const KV* vb = vcache + kv_base;
    const size_t gh = ((size_t)b * G + g) * Hkv + h;
    for (int mi = 0; mi < M; ++mi) {
      const int blk = merged[gh * M + mi];
      if (blk < 0 || mvalid[gh * M + mi] == 0 || blk * sel_block >= plen) continue;
      const long blk_off = token_off(blk * sel_block);   // one page holds the block
      if (blk_off < 0) continue;
      const int* own_m = own + gh * (size_t)C * M + mi;     // own_m[c*M]
      for (int o0 = 0; o0 < sel_block; o0 += TK) {
        const int tok0 = blk * sel_block + o0;
        if (tok0 >= plen) break;
        tile(sm.t, sm.m[1], sm.l[1], acc[1], kb, vb, min(TK, sel_block - o0), R,
                [&](int kk) -> long {
                  return tok0 + kk < S ? blk_off + (long)(o0 + kk) * (long)kv_row : -1L;
                },
                [&](int r, int kk) {
                  const int tok = tok0 + kk;
                  return tok < plen && tok <= sm.pos[r] && own_m[sm.c_of[r] * M] > 0;
                });
      }
    }
  }

  // ---- win branch: trailing window of the prefix, then the draft tokens
  if (branch != 1) {
    const KV* kb = kcache + kv_base;
    const KV* vb = vcache + kv_base;
    for (int t0 = 0; t0 < W; t0 += TK) {
      const int kp0 = ws + t0;
      if (kp0 >= plen) break;
      tile(sm.t, sm.m[2], sm.l[2], acc[2], kb, vb, min(TK, W - t0), R,
              [&](int kk) -> long { return token_off(kp0 + kk); },
              [&](int r, int kk) {
                const int kp = kp0 + kk;
                return kp < plen && kp > sm.pos[r] - window && kp <= sm.pos[r];
              });
    }
    const KV* kd = kdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const KV* vd = vdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const int* dm = dmask + (size_t)b * T * T;
    for (int t0 = 0; t0 < T; t0 += TK) {
      tile(sm.t, sm.m[2], sm.l[2], acc[2], kd, vd, min(TK, T - t0), R,
              [&](int kk) -> long { return (long)(t0 + kk) * (long)kv_row; },
              [&](int r, int kk) { return dm[(size_t)sm.qi[r] * T + t0 + kk] > 0; });
    }
  }

  // ---- gated combine (vanilla: the one ungated branch), one write per
  // real query row
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
    if (branch != 0) {
      out[row * DH + d] = o[branch];
      continue;
    }
    const float* gt = gates + ((size_t)b * T + qi) * 3 * Hq;
    const float o_cmp = include_cmp ? o[0] : ocmp_in[row * DH + d];
    out[row * DH + d] = gt[head] * o_cmp + gt[Hq + head] * o[1] + gt[2 * Hq + head] * o[2];
  }
}

template <typename KV, int DH>
int launch(const void* const* p, const int* n, cudaStream_t stream) {
  // n: B, T, S, Hkv, Gq, C, G, M, NCB, W, sel_block, cmp_block, cmp_stride,
  //    window, include_cmp, branch, DH, ps, MP, P
  const size_t smem = sizeof(Smem<DH>);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        nsa_verify_kernel<KV, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n[6], n[3], n[0]);
  nsa_verify_kernel<KV, DH><<<grid, NT, smem, stream>>>(
      (const float*)p[0], (const KV*)p[1], (const KV*)p[2], (const KV*)p[3],
      (const KV*)p[4], (const KV*)p[5], (const KV*)p[6], (const int*)p[7],
      (const int*)p[8], (const int*)p[9], (const int*)p[10], (const int*)p[11],
      (const int*)p[12], (const int*)p[13], (const int*)p[14], (const int*)p[15],
      (const float*)p[16], (const float*)p[17], (float*)p[18], (const int*)p[19],
      n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8], n[9], n[10], n[11],
      n[12], n[13], n[14], n[15], n[17], n[18], n[19]);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged, mvalid,
//       own, qmap, positions, prefix_len, ncb_valid, win_start, dmask,
//       gates, o_cmp_in (may be null), out, page_table (null = dense)
//       (20 pointers)
// ints: B, T, S, Hkv, Gq, C, G, M, NCB, W, sel_block, cmp_block,
//       cmp_stride, window, include_cmp, branch, DH, ps, MP, P  (20 ints;
//       paged: k/v_cache are the (P, ps, Hkv, DH) pool, S = MP * ps)
// branch: 0 = gated combine of all branches, 1 = slc only, 2 = win + draft
// only (vanilla; needs include_cmp = 0, no o_cmp_in). kv_dtype: 0 =
// float32, 1 = bfloat16. DH: 64 or 128. Returns the cudaError_t of the
// launch.
extern "C" int nsa_verify_launch(const void* const* ptrs, const int* ints,
                                 int kv_dtype, void* stream) {
  const int Gq = ints[4], C = ints[5], branch = ints[15], DH = ints[16];
  if (C * Gq < 1 || C * Gq > RMAX) return (int)cudaErrorInvalidValue;
  if (branch < 0 || branch > 2 || (branch != 0 && ints[14]))
    return (int)cudaErrorInvalidValue;
  if (branch == 0 && !ints[14] && ptrs[17] == nullptr) return (int)cudaErrorInvalidValue;
  if (ptrs[19] != nullptr &&
      (ints[17] < 1 || ints[17] % ints[10] || ints[18] < 1 || ints[19] < 1 ||
       ints[2] != ints[17] * ints[18]))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == 0 && DH == 64) return launch<float, 64>(ptrs, ints, s);
  if (kv_dtype == 0 && DH == 128) return launch<float, 128>(ptrs, ints, s);
  if (kv_dtype == 1 && DH == 64) return launch<__nv_bfloat16, 64>(ptrs, ints, s);
  if (kv_dtype == 1 && DH == 128) return launch<__nv_bfloat16, 128>(ptrs, ints, s);
  return (int)cudaErrorInvalidValue;
}
