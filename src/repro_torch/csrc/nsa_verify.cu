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
// Head dims 64, 128, 160, 192 and 256 are template instances (HEAD_DIMS).
//
// Paged mode (the TPU kernel's paged=True, kernel.py:193-210 with the page
// table as its sixth scalar-prefetch operand, :236): with a non-null page
// table the K/V cache is the shared pool (P, ps, Hkv, DH) and token tok of
// row b lives at pool row pages[b*MP + tok/ps]*ps + tok%ps (-1 entries and
// ids past the pool read zeros). A merged selected block never straddles a
// page (ps % sel_block == 0), so it resolves once per block; a window unit
// may straddle pages, so each of its key rows resolves once (one page-table
// load per key row, by the lane that copies it). An unmapped page inside
// the window reads zeros that still pass the position mask (the JAX paged
// window); merged blocks on unmapped pages arrive with mvalid cleared.
// Paging is a runtime null check, not a template flag. The pool is read in
// place, never copied per row.
//
// Work split. Per (query group g of C adjacent tree queries, kv head h,
// batch row b) the work list is, per branch: the NCB cmp blocks, the M
// merged selected blocks, and the W window keys followed by the T draft
// tokens. Each branch's list is cut into chunks of a fixed size (`keys`
// cmp blocks or window keys, `blocks` merged blocks; the draft joins the
// last window chunk), and one CTA takes one chunk: the grid is
// (G * NRT * NX, Hkv, B) with NX = n_cmp + n_slc + n_win chunks. The plan
// is a function of shapes only (ops.py:split_plan), never of lengths or B.
// Rows. The group has R = C*Gq query rows (row c*Gq + i: query c, head i
// of the kv head), cut into NRT = ceil(R / 16) row tiles of 16; one CTA
// takes one (row tile, chunk) pair, so a group above 16 rows (approx C=4
// at Gq 6: 24 rows; Gq 48 under MQA: 96 or 192) walks each chunk's K/V
// once per row tile (NRT times, from L2 after the first) and each tile
// merges its own rows under its own ticket; the ownership bits and the
// masks stay per query. NRT = 1 up to 16 rows, as before.
// A CTA holds the tile's up to 16 query rows and walks its chunk in
// units of 16 keys, four warps each with its own online softmax, K/V
// copied with cp.async into per-warp rings, dots on tensor cores for bf16
// K/V (online_softmax.cuh, shared with flash_verify.cu). Units that no row
// can see (a cmp block past the deepest row, an invalid merged block, keys
// past prefix_len) are never copied; a chunk with none writes an empty
// partial (l = 0). Each CTA writes its partial (m, l, acc) per row to f32
// scratch; the last CTA of (b, g, h, row tile) to finish (an atomic ticket,
// reset by it) merges the partials of each branch in chunk order, applies the
// learned gates (vanilla: the one branch, ungated) and writes each real
// query row once. The merge order is fixed, so a row's output does not
// depend on B or on the run. Masks are the TPU kernel's: cmp visibility
// and ncb_valid; slc ownership, prefix and causality; window prefix/window/
// causality; draft tree mask (with window distance, built by the wrapper).
//
// The per-row scalars prefix_len, ncb_valid and win_start arrive as device
// int32 tensors of shape (B,), so a layer never waits on the host. The
// merged schedule and the ownership masks are built in PyTorch around the
// launch, as the JAX package builds them in jnp.
//
// Groups of at most 8 rows (exact C=2, vanilla C=1 at Gq 4) run an
// instance with one n8 row tile, the others one with two.
//
// Bound on this card: bytes. With the dots on tensor cores (bf16), the
// flops of the visible (row, key) pairs take far less time than the bytes
// the function must move: the union of the selected blocks per head plus
// the window, cmp and draft K/V of each head, each read once. The kernel
// reads a block once per group that selected it (from L2 after the first
// group), and its partials go through L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "online_softmax.cuh"

namespace {

using namespace online_softmax;

constexpr int MBMAX = 32;              // merged blocks per slc chunk
constexpr int NXMAX = 256;             // chunks per (b, g, h): the merge table 2 x NXMAX x RT
                                       // floats fits every instance's ring scratch

template <typename KV, int DH>
struct Smem {
  Walk<KV, DH> wk;                     // rings, q, warp merge; merge tables
  int blk_off[MBMAX];                  // a chunk's blocks: offset from kv_base, -1 = none
  int blk_tok[MBMAX];                  // first token of the block
  int blk_own[MBMAX];                  // bit c: query c of the group owns it
  int pos[RT];
  int qi[RT];
  int c_of[RT];
  int last;
};

// Launch bounds set ptxas' register budget (without a minimum it spilled a
// few bytes in some instances): one row tile fits five CTAs per SM (bf16)
// or four (f32) without spills up to head dim 128; above it the
// accumulator (DH / 16 x 4 floats a thread) needs the budget of three
// (170 registers), and f32 at head dim 256 that of two (255: its CUDA-core
// dots hold q and K in registers too); two row tiles take what they need.
template <typename KV, int DH>
constexpr int min_ctas_one_tile() {
  return DH > 192 && sizeof(KV) == 4 ? 2 : DH > 128 ? 3 : sizeof(KV) == 2 ? 5 : 4;
}

template <typename KV, int DH, int NTL>
__global__ void __launch_bounds__(NT, NTL == 2 ? 1 : min_ctas_one_tile<KV, DH>())
    nsa_verify_kernel(
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
    float* __restrict__ part_ml,          // (B,G,Hkv,NRT,NX,RT,2): m, l
    float* __restrict__ part_acc,         // (B,G,Hkv,NRT,NX,RT,DH)
    int* __restrict__ tickets,            // (B,G,Hkv,NRT), all 0 between calls
    int T, int S, int Hkv, int Gq, int C, int G, int M, int NCB, int W,
    int sel_block, int cmp_block, int cmp_stride, int window,
    int include_cmp, int branch, int ps, int MP, int P,
    int n_cmp, int n_slc, int n_win, int keys, int blocks, int NRT) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<KV, DH>& sm = *reinterpret_cast<Smem<KV, DH>*>(smem_raw);
  const int NX = n_cmp + n_slc + n_win;
  const int g = blockIdx.x / (NRT * NX), x = blockIdx.x % NX;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x / NX % NRT * RT;   // the row tile's first row of the group
  const int R = min(RT, C * Gq - r0), Hq = Hkv * Gq;
  const int plen = prefix_len[b], ncbv = ncb_valid[b], ws = win_start[b];
  const size_t gh = ((size_t)b * G + g) * Hkv + h;
  const size_t kv_row = (size_t)Hkv * DH;
  // K/V base of this (row, head): the row's own cache, or the shared pool
  const size_t kv_base = (pages ? 0 : (size_t)b * S * kv_row) + (size_t)h * DH;
  const int* prow = pages ? pages + (size_t)b * MP : nullptr;
  // element offset of position tok's K/V row from kv_base, -1 = zeros (the
  // wrapper keeps every cache under 2^31 elements)
  auto token_off = [&](int tok) -> int {
    if (tok < 0 || tok >= S) return -1;
    if (!prow) return tok * (int)kv_row;
    const int phys = prow[tok / ps];
    if (phys < 0 || phys >= P) return -1;
    return (phys * ps + tok % ps) * (int)kv_row;
  };
  // an slc chunk's merged blocks [m0, m0 + nb), each resolved once (first,
  // beside the row loads below: it needs neither)
  const bool is_slc = x >= n_cmp && x < n_cmp + n_slc;
  const int m0 = (x - n_cmp) * blocks, nb = is_slc ? min(blocks, M - m0) : 0;
  for (int j = tid; j < nb; j += NT) {
    const int blk = merged[gh * M + m0 + j];
    int off = -1;
    if (blk >= 0 && mvalid[gh * M + m0 + j] != 0 && blk * sel_block < plen)
      off = token_off(blk * sel_block);             // one page holds the block
    int owners = 0;                                 // bit c: query c owns the block
    for (int c = 0; c < C; ++c)
      owners |= (own[(gh * C + c) * M + m0 + j] > 0) << c;
    sm.blk_off[j] = off;
    sm.blk_tok[j] = blk * sel_block;
    sm.blk_own[j] = owners;
  }

  for (int r = tid; r < RT; r += NT) {
    const int c = r < R ? (r0 + r) / Gq : 0;
    const int qi = qmap[g * C + c];
    sm.qi[r] = qi;
    sm.c_of[r] = c;
    sm.pos[r] = pos[b * T + qi];
  }
  __syncthreads();                       // the rows and the block table are in place
  int max_pos = 0;
  for (int r = 0; r < R; ++r) max_pos = max(max_pos, sm.pos[r]);
  // q, loaded while the first units' copies are in flight
  auto load_q = [&]() {
    for (int i = tid; i < RT * DH; i += NT) {
      const int r = i / DH, d = i % DH;
      const int head = h * Gq + (r0 + r) % Gq;
      sm.wk.q.set(r, d, r < R ? q[(((size_t)b * T + sm.qi[r]) * Hq + head) * DH + d] : 0.f);
    }
    __syncthreads();
  };

  State<DH, NTL> st;
  st.init();
  const KV* kc = kcache + kv_base;
  const KV* vc = vcache + kv_base;
  if (x < n_cmp) {
    // ---- cmp chunk: visible blocks form a prefix bounded by the deepest row
    int nv = (max_pos - cmp_block + 1 >= 0) ? (max_pos - cmp_block + 1) / cmp_stride + 1 : 0;
    nv = max(0, min(nv, min(ncbv, NCB)));
    const int lo = x * keys, hi = min(lo + keys, nv);
    const KV* kb = kcmp + (size_t)b * NCB * kv_row + (size_t)h * DH;
    const KV* vb = vcmp + (size_t)b * NCB * kv_row + (size_t)h * DH;
    walk(sm.wk, st, hi > lo ? (hi - lo + UK - 1) / UK : 0, R, kcache,
         [&](int u) { return lo + u * UK; },            // first cmp block
         [](int) { return true; },
         [&](int) { return Rows<KV>{kb, vb}; },
         [&](int n0, int kk) { return n0 + kk < hi ? (n0 + kk) * (int)kv_row : -1; },
         [&](int n0) { return min(UK, hi - n0); },
         [&](int n0, int r, int kk) {
           const int n = n0 + kk;
           return n < ncbv && n * cmp_stride + cmp_block - 1 <= sm.pos[r];
         }, load_q);
  } else if (is_slc) {
    // ---- slc chunk: the merged blocks of the table, `sub` units each
    const int sub = (sel_block + UK - 1) / UK;
    struct Unit { int j, o, tok; };                  // block, offset in it, its token
    walk(sm.wk, st, max(nb, 0) * sub, R, kcache,
         [&](int u) {
           const int j = u / sub, o = (u - j * sub) * UK;
           return Unit{j, o, sm.blk_tok[j] + o};
         },
         [&](const Unit& i) { return sm.blk_off[i.j] >= 0 && i.tok < plen; },
         [&](const Unit&) { return Rows<KV>{kc, vc}; },
         [&](const Unit& i, int kk) {
           if (i.o + kk >= sel_block || i.tok + kk >= S) return -1;
           return sm.blk_off[i.j] + (i.o + kk) * (int)kv_row;
         },
         [&](const Unit& i) { return min(UK, sel_block - i.o); },
         [&](const Unit& i, int r, int kk) {
           const int tok = i.tok + kk;
           return tok < plen && tok <= sm.pos[r] && ((sm.blk_own[i.j] >> sm.c_of[r]) & 1);
         }, load_q);
  } else {
    // ---- win chunk: window keys [ws + lo, ws + hi) of the prefix; the last
    // chunk adds the draft tokens
    const int xw = x - n_cmp - n_slc;
    const int lo = xw * keys, hi = min(min(lo + keys, W), plen - ws);
    const int nwu = hi > lo ? (hi - lo + UK - 1) / UK : 0;
    const int ndu = xw == n_win - 1 ? (T + UK - 1) / UK : 0;
    const KV* kd = kdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const KV* vd = vdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const int* dm = dmask + (size_t)b * T * T;
    // unit u: window keys from k0 (k0 >= 0), or draft tokens from -k0 - 1
    walk(sm.wk, st, nwu + ndu, R, kcache,
         [&](int u) { return u < nwu ? lo + u * UK : -(u - nwu) * UK - 1; },
         [](int) { return true; },
         [&](int k0) { return k0 >= 0 ? Rows<KV>{kc, vc} : Rows<KV>{kd, vd}; },
         [&](int k0, int kk) {
           if (k0 >= 0) return k0 + kk < hi ? token_off(ws + k0 + kk) : -1;
           const int d = -k0 - 1 + kk;
           return d < T ? d * (int)kv_row : -1;
         },
         [&](int k0) { return k0 >= 0 ? min(UK, hi - k0) : min(UK, T + k0 + 1); },
         [&](int k0, int r, int kk) {
           if (k0 >= 0) {
             const int kp = ws + k0 + kk;
             return kp < plen && kp > sm.pos[r] - window && kp <= sm.pos[r];
           }
           return dm[(size_t)sm.qi[r] * T - k0 - 1 + kk] > 0;
         }, load_q);
  }

  // ---- this chunk's partial; the last CTA of (b, g, h, row tile) merges them
  const size_t ght = gh * NRT + blockIdx.x / NX % NRT;   // the tile's ticket and partials
  const float* mlg = part_ml + ght * NX * RT * 2;
  const float* accg = part_acc + ght * NX * RT * DH;
  cta_partial(sm.wk, st, part_ml + (ght * NX + x) * RT * 2, part_acc + (ght * NX + x) * RT * DH);
  if (!last_of(tickets + ght, NX, &sm.last)) return;

  // scale of chunk x's partial for row r: exp(m - M) / L of its branch
  float* sc = sm.wk.scratch();                       // [NX][RT]
  float* xl = sc + NX * RT;                          // [NX][RT]
  for (int i = tid; i < NX * RT; i += NT) {
    sc[i] = __ldcg(mlg + 2 * i);
    xl[i] = __ldcg(mlg + 2 * i + 1);
  }
  __syncthreads();
  // chunks of branch br: [x_of(br), x_of(br + 1))
  auto x_of = [&](int br) { return br == 0 ? 0 : br == 1 ? n_cmp : br == 2 ? n_cmp + n_slc : NX; };
  for (int pr = tid >> 5; pr < 3 * RT; pr += NW)
    merge_scales(sc, xl, pr % RT, x_of(pr / RT), x_of(pr / RT + 1));
  __syncthreads();

  // ---- gated combine (vanilla: the one ungated branch), one write per
  // real query row
  for (int i = tid; i < R * DH / 4; i += NT) {
    const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
    const int c = sm.c_of[r];
    if (g * C + c >= T) continue;       // padded replica of the last query
    const float* a = accg + (size_t)r * DH + d;
    const float4 o_cmp = merge_acc(sc, r, a, (size_t)RT * DH, x_of(0), x_of(1));
    const float4 o_slc = merge_acc(sc, r, a, (size_t)RT * DH, x_of(1), x_of(2));
    const float4 o_win = merge_acc(sc, r, a, (size_t)RT * DH, x_of(2), x_of(3));
    const int qi = sm.qi[r];
    const int head = h * Gq + (r0 + r) % Gq;
    const size_t row = ((size_t)b * T + qi) * Hq + head;
    float4* dst = reinterpret_cast<float4*>(out + row * DH + d);
    if (branch != 0) {
      *dst = branch == 1 ? o_slc : o_win;
      continue;
    }
    const float* gt = gates + ((size_t)b * T + qi) * 3 * Hq;
    const float g0 = gt[head], g1 = gt[Hq + head], g2 = gt[2 * Hq + head];
    const float4 oc =
        include_cmp ? o_cmp : *reinterpret_cast<const float4*>(ocmp_in + row * DH + d);
    *dst = make_float4(g0 * oc.x + g1 * o_slc.x + g2 * o_win.x,
                       g0 * oc.y + g1 * o_slc.y + g2 * o_win.y,
                       g0 * oc.z + g1 * o_slc.z + g2 * o_win.z,
                       g0 * oc.w + g1 * o_slc.w + g2 * o_win.w);
  }
}

template <typename KV, int DH, int NTL>
int launch_rows(const void* const* p, const int* n, cudaStream_t stream) {
  // n: B, T, S, Hkv, Gq, C, G, M, NCB, W, sel_block, cmp_block, cmp_stride,
  //    window, include_cmp, branch, DH, ps, MP, P, n_cmp, n_slc, n_win,
  //    keys, blocks, NRT
  const int NX = n[20] + n[21] + n[22];
  if (NX < 1 || NX > NXMAX || n[24] < 1 || n[24] > MBMAX || n[23] < 1 ||
      2 * NX * RT > Walk<KV, DH>::SCRATCH)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<KV, DH>);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        nsa_verify_kernel<KV, DH, NTL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n[6] * n[25] * NX, n[3], n[0]);
  nsa_verify_kernel<KV, DH, NTL><<<grid, NT, smem, stream>>>(
      (const float*)p[0], (const KV*)p[1], (const KV*)p[2], (const KV*)p[3],
      (const KV*)p[4], (const KV*)p[5], (const KV*)p[6], (const int*)p[7],
      (const int*)p[8], (const int*)p[9], (const int*)p[10], (const int*)p[11],
      (const int*)p[12], (const int*)p[13], (const int*)p[14], (const int*)p[15],
      (const float*)p[16], (const float*)p[17], (float*)p[18], (const int*)p[19],
      (float*)p[20], (float*)p[21], (int*)p[22],
      n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8], n[9], n[10], n[11],
      n[12], n[13], n[14], n[15], n[17], n[18], n[19], n[20], n[21], n[22], n[23], n[24],
      n[25]);
  return (int)cudaGetLastError();
}

// one n8 row tile for groups of at most 8 rows (exact C=2, vanilla at
// Gq 4), two otherwise (every 16-row tile of a larger group)
template <typename KV, int DH>
int launch(const void* const* p, const int* n, cudaStream_t stream) {
  return n[4] * n[5] <= 8 ? launch_rows<KV, DH, 1>(p, n, stream)
                          : launch_rows<KV, DH, 2>(p, n, stream);
}

}  // namespace

// the head dims with template instances
#define HEAD_DIMS(X) X(64) X(128) X(160) X(192) X(256)

// ptrs: q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged, mvalid,
//       own, qmap, positions, prefix_len, ncb_valid, win_start, dmask,
//       gates, o_cmp_in (may be null), out, page_table (null = dense),
//       part_ml, part_acc, tickets                        (23 pointers)
// ints: B, T, S, Hkv, Gq, C, G, M, NCB, W, sel_block, cmp_block,
//       cmp_stride, window, include_cmp, branch, DH, ps, MP, P, n_cmp,
//       n_slc, n_win, keys, blocks, NRT  (26 ints; paged: k/v_cache are the
//       (P, ps, Hkv, DH) pool, S = MP * ps; n_cmp .. blocks are the split
//       plan, ops.py:split_plan; NRT = ceil(C * Gq / 16) row tiles)
// branch: 0 = gated combine of all branches, 1 = slc only, 2 = win + draft
// only (vanilla; needs include_cmp = 0, no o_cmp_in). kv_dtype: 0 =
// float32, 1 = bfloat16. DH: 64, 128, 160, 192 or 256. Scratch (NX = n_cmp + n_slc +
// n_win): part_ml B*G*Hkv*NRT*NX*16*2 floats, part_acc
// B*G*Hkv*NRT*NX*16*DH floats, tickets B*G*Hkv*NRT ints, zero before the
// first call. Returns the cudaError_t of the launch.
extern "C" int nsa_verify_launch(const void* const* ptrs, const int* ints,
                                 int kv_dtype, void* stream) {
  const int Gq = ints[4], C = ints[5], branch = ints[15], DH = ints[16];
  if (C * Gq < 1 || ints[25] != (C * Gq + RT - 1) / RT) return (int)cudaErrorInvalidValue;
  if (branch < 0 || branch > 2 || (branch != 0 && ints[14]))
    return (int)cudaErrorInvalidValue;
  if (branch == 0 && !ints[14] && ptrs[17] == nullptr) return (int)cudaErrorInvalidValue;
  if (ptrs[19] != nullptr &&
      (ints[17] < 1 || ints[17] % ints[10] || ints[18] < 1 || ints[19] < 1 ||
       ints[2] != ints[17] * ints[18]))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define X(D)                                                           \
  if (kv_dtype == 0 && DH == D) return launch<float, D>(ptrs, ints, s); \
  if (kv_dtype == 1 && DH == D) return launch<__nv_bfloat16, D>(ptrs, ints, s);
  HEAD_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the instance (kv_dtype, DH), or -1.
extern "C" int nsa_verify_smem_bytes(int kv_dtype, int DH) {
#define X(D)                                                             \
  if (kv_dtype == 0 && DH == D) return (int)sizeof(Smem<float, D>);       \
  if (kv_dtype == 1 && DH == D) return (int)sizeof(Smem<__nv_bfloat16, D>);
  HEAD_DIMS(X)
#undef X
  return -1;
}
