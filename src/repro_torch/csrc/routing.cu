// Routing kernel for Hopper (sm_90a): the refresh-layer "routing launch"
// of SSV (paper §5.1) — compressed-branch attention and GQA-shared
// selection-block scores in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/routing/kernel.py:23
// (make_kernel) + :70 (build_routing_call), driven by
// src/repro/kernels/routing/ops.py:29 (routing_fused).
//
// Contract (same as routing_fused): q (B,T,Hq,DH) f32, already scaled by
// 1/sqrt(DH); k_cmp/v_cmp (B,NCB,Hkv,DH) in f32 or bf16; positions (B,T)
// and ncb_valid (B,) int32 on the device. Outputs o_cmp (B,T,Hq,DH) f32 and
// p_slc (B,T,Hkv,NSB) f32, p_slc summed over the Gq query heads of each
// kv head.
//
// Design: the cmp chunk of nsa_verify.cu on the shared tile walk
// (online_softmax.cuh), plus the selection scores.
// - Rows. A CTA holds RT = 16 rows: Q = min(16 / Gq, T) consecutive tree
//   queries x the Gq query heads of one kv head (4 queries at Gq 4), so
//   the GQA sum of p_slc stays inside the CTA (no atomics). G = ceil(T / Q)
//   query groups; rows past T are padding, masked and never written. At
//   Gq > 16 (MQA granite: 48) a query's heads do not fit one CTA: they
//   are cut into HS = ceil(Gq / 16) head slabs of up to 16 heads (Q = 1),
//   one CTA per slab and chunk, all under the group's one ticket; the last
//   CTA merges the slabs one after another and adds each slab's GQA sum
//   to p_slc in slab order (the GQA sum over Gq heads, split in fixed
//   pieces). HS = 1 below 17 heads.
// - Split. The cmp list (capacity NCB, never the visible length: no host
//   sync) is cut into n_cmp chunks of `keys` blocks (ops.py:routing_plan,
//   shapes only: `keys` grows with NCB up to KMAX so that a long cache
//   keeps few chunks, and past SPLITS x KMAX blocks the chunks grow in
//   number, up to NXMAX: 65 at 524,800 tokens); grid (G * HS * n_cmp,
//   Hkv, B). Visibility is a prefix of
//   the blocks (block ends grow with the index), so a chunk walks its blocks
//   below the deepest row's visible prefix; a chunk past it walks none and
//   still takes its ticket, as do rows with ncb_valid 0.
// - Walk. 16-block units dealt to 4 warps, each with its own online
//   softmax and cp.async ring; bf16 dots on tensor cores (mma.sync
//   m16n8k16, f32 q split into hi + lo bf16 terms), f32 K/V on CUDA cores.
//   A hook keeps each unit's raw logits in shared memory (RT x KMAX
//   floats, 33 KB).
// - Selection scores in o_cmp's rescaled space (the TPU kernel's
//   kernel.py:47-65). After the warp merge the CTA knows m and l per row;
//   it turns its logits into chunk-local scores sum_n exp(s_rn - m_r) *
//   ov(n, j) / cmp_block over the few selection blocks j its chunk
//   touches (`span` of them from its first). The overlap matrix M is
//   banded, so the weights come from the geometry; no M is loaded.
// - Merge. Each CTA writes its partial (m, l, acc) and its scores per row
//   to f32 scratch; the last CTA of (b, group, kv head) (an atomic ticket,
//   reset by it) turns the partials' m and l into scales exp(m_x - M) / L,
//   applies them to o_cmp's accumulators and to each chunk's scores, sums
//   chunks and then the rows of each query in a fixed order and writes
//   each real query once (a later head slab adds to what the earlier ones
//   wrote). Rows with L = 0 give zeros in both outputs. The
//   order does not depend on B or the run, so a row is bitwise the same
//   at any B and across calls. The scores reach the last CTA through
//   shared memory (cp.async, one round trip per stage of chunks, the
//   first overlapping the o_cmp merge): a tail that read them one output
//   at a time cost as much as the walk.
// Scratch (floats): part_ml B*G*Hkv*HS*n_cmp*16*2, part_acc
// B*G*Hkv*HS*n_cmp*16*DH, part_sc B*G*Hkv*HS*n_cmp*16*span; tickets B*G*Hkv
// ints. At B 4, Hkv 8,
// T 31, Gq 4 (G 8), max_context 65536 (NCB 4096 blocks: 8 chunks of 512,
// span 130) that is 4*8*8*8*16*(2+DH+130)*4 B: 25.7 MB at DH 64, 34.1 MB
// at DH 128, below nsa_verify's part_acc at the same shapes (exact C=2,
// full fusion: 16 groups x 13 chunks, 27.3 / 54.5 MB). The scores take
// about NCB/4 floats per row whatever the split, so fewer, longer chunks
// are what keeps the scratch small.
//
// Bound on this card: bytes for bf16 K/V (the visible cmp K/V of each head
// once, q in, o_cmp and p_slc out), with the dots on tensor cores; f32
// operations for f32 K/V (CUDA cores). Head dims 64, 128, 160, 192 and
// 256 are template instances (HEAD_DIMS).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "online_softmax.cuh"

namespace {

using namespace online_softmax;

constexpr int KMAX = 512;              // cmp blocks per chunk (the logit buffer)
constexpr int NXMAX = 256;             // chunks per (b, group, kv head): the merge table
                                       // 2 x NXMAX x RT floats fits every instance's scratch

template <typename KV, int DH>
struct Smem {
  Walk<KV, DH> wk;                     // rings, q, warp merge; merge tables
  __align__(16) float sl[RT][KMAX + 4];  // raw logits; the last CTA's staged scores
  int pos[RT];                         // position of each row, -1 for padding
  int last;
};

template <typename KV, int DH>
// (launch bounds without a minimum let ptxas cap the Dh-64 instances at
// 80 registers and spill; a minimum of one CTA lifts the cap, as in
// nsa_verify.cu's two-row-tile instances)
__global__ void __launch_bounds__(NT, 1) routing_kernel(
    const float* __restrict__ q,          // (B,T,Hq,DH) pre-scaled
    const KV* __restrict__ kc, const KV* __restrict__ vc,   // (B,NCB,Hkv,DH)
    const int* __restrict__ pos,          // (B,T)
    const int* __restrict__ ncb_valid,    // (B,)
    float* __restrict__ o,                // (B,T,Hq,DH)
    float* __restrict__ p_slc,            // (B,T,Hkv,NSB)
    float* __restrict__ part_ml,          // (B,G,Hkv,HS,NX,RT,2): m, l
    float* __restrict__ part_acc,         // (B,G,Hkv,HS,NX,RT,DH)
    float* __restrict__ part_sc,          // (B,G,Hkv,HS,NX,RT,span)
    int* __restrict__ tickets,            // (B,G,Hkv), all 0 between calls
    int T, int Hkv, int Gq, int Q, int G, int NCB, int NSB, int cmp_block,
    int cmp_stride, int sel_block, int NX, int keys, int span, int HS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<KV, DH>& sm = *reinterpret_cast<Smem<KV, DH>*>(smem_raw);
  const int gi = blockIdx.x / (HS * NX), sx = blockIdx.x % (HS * NX), h = blockIdx.y,
            b = blockIdx.z;
  const int hs = sx / NX, x = sx % NX;                  // head slab, chunk
  const int tid = threadIdx.x;
  const int Hq = Hkv * Gq, gs = min(Gq, RT);            // heads per slab
  // slab s holds heads [s * gs, s * gs + nh(s)) of Q queries: row r is
  // query gi * Q + r / nh(s), head h * Gq + s * gs + r % nh(s); rows past
  // Q * nh(s) or T are padding
  auto nh = [&](int s) { return min(gs, Gq - s * gs); };
  auto query = [&](int s, int r) { return gi * Q + r / nh(s); };
  auto real = [&](int s, int r) { return r < Q * nh(s) && query(s, r) < T; };
  auto qrow = [&](int s, int r) {                       // (b, query, head) row of q and o
    return ((size_t)b * T + query(s, r)) * Hq + h * Gq + s * gs + r % nh(s);
  };
  const int R = Q * nh(hs);
  const int ncbv = min(ncb_valid[b], NCB);
  const size_t gh = ((size_t)b * G + gi) * Hkv + h;     // the ticket of (b, group, kv head)
  const size_t NXT = (size_t)HS * NX;                   // CTAs per ticket
  const size_t kv_row = (size_t)Hkv * DH;

  for (int r = tid; r < RT; r += NT) sm.pos[r] = real(hs, r) ? pos[b * T + query(hs, r)] : -1;
  __syncthreads();
  int max_pos = -1;
  for (int r = 0; r < R; ++r) max_pos = max(max_pos, sm.pos[r]);
  // cmp block n is visible to row r iff n < ncb_valid and
  // n * stride + cmp_block - 1 <= pos[r]: a prefix of the blocks
  int nv = (max_pos - cmp_block + 1 >= 0) ? (max_pos - cmp_block + 1) / cmp_stride + 1 : 0;
  nv = max(0, min(nv, ncbv));
  const int lo = x * keys, hi = min(lo + keys, nv);
  auto visible = [&](int n, int r) {
    return n < ncbv && n * cmp_stride + cmp_block - 1 <= sm.pos[r];
  };
  // q, loaded while the first units' copies are in flight
  auto load_q = [&]() {
    for (int i = tid; i < RT * DH; i += NT) {
      const int r = i / DH, d = i % DH;
      sm.wk.q.set(r, d, real(hs, r) ? q[qrow(hs, r) * DH + d] : 0.f);
    }
    __syncthreads();
  };

  State<DH, 2> st;
  st.init();
  const KV* kb = kc + (size_t)b * NCB * kv_row + (size_t)h * DH;
  const KV* vb = vc + (size_t)b * NCB * kv_row + (size_t)h * DH;
  walk(sm.wk, st, hi > lo ? (hi - lo + UK - 1) / UK : 0, R, kc,
       [&](int u) { return lo + u * UK; },                // first cmp block
       [](int) { return true; },
       [&](int) { return Rows<KV>{kb, vb}; },
       [&](int n0, int kk) { return n0 + kk < hi ? (n0 + kk) * (int)kv_row : -1; },
       [&](int n0) { return min(UK, hi - n0); },
       [&](int n0, int r, int kk) { return visible(n0 + kk, r); }, load_q,
       [&](int n0, const float (&s)[2][4]) {               // keep the raw logits
         const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
         for (int n = 0; n < 2; ++n)
#pragma unroll
           for (int c = 0; c < 4; ++c)
             sm.sl[8 * n + 2 * t + (c & 1)][n0 - lo + g + 8 * (c >> 1)] = s[n][c];
       });

  // ---- this chunk's partial (leaves m, l per row in cm, cl)
  const size_t px = gh * NXT + sx;                      // this CTA's partial
  cta_partial(sm.wk, st, part_ml + px * RT * 2, part_acc + px * RT * DH);

  // ---- chunk-local selection scores of the rows with l > 0: each warp
  // takes rows warp, warp + 4, ... and its lanes the (row, selection block
  // j0 + jj) pairs of those rows; a pair sums exp(s - m) * ov / cmp_block
  // over the few visible blocks that overlap the selection block
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = lo * cmp_stride / sel_block;           // the chunk's first selection block
  const float inv_cmp = 1.f / (float)cmp_block;
  const int nrw = (R - warp + NW - 1) / NW;             // rows of this warp
  for (int i = lane; i < nrw * span; i += 32) {
    const int r = warp + NW * (i / span), jj = i % span;
    if (!(sm.wk.cl[r] > 0.f)) continue;
    const int lo_tok = (j0 + jj) * sel_block, hi_tok = lo_tok + sel_block;
    const int first = lo_tok - cmp_block + 1;           // blocks n with n * stride >= first
    const int n_lo = max(lo, first <= 0 ? 0 : (first + cmp_stride - 1) / cmp_stride);
    const int n_hi = min(hi - 1, (hi_tok - 1) / cmp_stride);
    const float m = sm.wk.cm[r];
    float a = 0.f;
    for (int n = n_lo; n <= n_hi; ++n) {
      const int ov = min(n * cmp_stride + cmp_block, hi_tok) - max(n * cmp_stride, lo_tok);
      if (ov > 0 && visible(n, r)) a += __expf(sm.sl[r][n - lo] - m) * ((float)ov * inv_cmp);
    }
    part_sc[(px * RT + r) * span + jj] = a;
  }
  if (!last_of(tickets + gh, (int)NXT, &sm.last)) return;

  // ---- the last CTA, one head slab after another. The chunks' scores go
  // through shared memory (the logit buffer, now free) in stages [xs, xb)
  // of as many chunks as fit; the first stage's cp.async copies overlap
  // the merge of o_cmp.
  float* stg = &sm.sl[0][0];                         // [chunk][RT][span]
  const int cap = (KMAX + 4) / span;                 // chunks per stage
  auto j0_of = [&](int xx) { return xx * keys * cmp_stride / sel_block; };
  for (int s = 0; s < HS; ++s) {
    const float* mlg = part_ml + gh * NXT * RT * 2 + (size_t)s * NX * RT * 2;
    const float* accg = part_acc + gh * NXT * RT * DH + (size_t)s * NX * RT * DH;
    const float* scg = part_sc + gh * NXT * RT * span + (size_t)s * NX * RT * span;
    const int ns = nh(s), Rs = Q * ns;
    auto stage = [&](int xs, int xb) {
      const float* src = scg + (size_t)xs * RT * span;
      for (int i = tid * 4; i < (xb - xs) * RT * span; i += NT * 4) cp16(stg + i, src + i, src);
      cp_commit();
    };
    int xa = 0, xs = 0, xb = min(NX, cap);
    stage(xs, xb);

    // scale of chunk x's partial for row r, exp(m - M) / L over the chunks
    // with l > 0 (0 for the others and when none has l > 0), a thread per
    // row, chunks in order
    float* sc = sm.wk.scratch();                       // [NX][RT]: m, then the scale
    float* xl = sc + NX * RT;                          // [NX][RT]: l
    for (int i = tid; i < NX * RT; i += NT) {
      sc[i] = __ldcg(mlg + 2 * i);
      xl[i] = __ldcg(mlg + 2 * i + 1);
    }
    __syncthreads();
    if (tid < RT) {
      float M = NEG, L = 0.f;
      for (int xx = 0; xx < NX; ++xx)
        if (xl[xx * RT + tid] > 0.f) M = fmaxf(M, sc[xx * RT + tid]);
      for (int xx = 0; xx < NX; ++xx)
        if (xl[xx * RT + tid] > 0.f) L += xl[xx * RT + tid] * expf(sc[xx * RT + tid] - M);
      for (int xx = 0; xx < NX; ++xx) {
        const int i = xx * RT + tid;
        sc[i] = xl[i] > 0.f ? expf(sc[i] - M) / L : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < Rs * DH / 4; i += NT) {
      const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
      if (!real(s, r)) continue;
      const float4 a = merge_acc(sc, r, accg + (size_t)r * DH + d, (size_t)RT * DH, 0, NX);
      *reinterpret_cast<float4*>(o + qrow(s, r) * DH + d) = a;
    }
    // p_slc[t][j]: the chunks whose span holds j (chunk x's starts at
    // x * keys * stride / sel_block) in order, then the slab's rows of query
    // t in order, added to the earlier slabs' sum. A stage writes the j below
    // chunk xb's first selection block, from chunk xa's on, and holds the
    // chunks before xa that those j need. Every slab has the same stages, so
    // a thread reads back only what it wrote itself. Scores of a row whose
    // scale is 0 are never read (may be unwritten).
    const int nq = min(Q, T - gi * Q);
    for (;;) {
      cp_wait_all();
      __syncthreads();
      const int ja = j0_of(xa), jb = xb == NX ? NSB : min(NSB, j0_of(xb));
      for (int i = tid; i < nq * max(jb - ja, 0); i += NT) {
        const int c = i / (jb - ja), j = ja + i % (jb - ja);
        float* dst = p_slc + (((size_t)b * T + gi * Q + c) * Hkv + h) * NSB + j;
        float a = s == 0 ? 0.f : *dst;
        for (int xx = xs; xx < xb; ++xx) {
          const int jj = j - j0_of(xx);
          if (jj < 0 || jj >= span) continue;
          for (int g = 0; g < ns; ++g) {
            const int r = c * ns + g;
            const float sr = sc[xx * RT + r];
            if (sr != 0.f) a += sr * stg[((xx - xs) * RT + r) * span + jj];
          }
        }
        *dst = a;
      }
      if (xb == NX) break;
      __syncthreads();
      xa = xb;
      while (xs < xa && j0_of(xa) - j0_of(xs) >= span) ++xs;   // the first chunk j0_of(xa) needs
      xb = min(NX, xs + cap);
      stage(xs, xb);
    }
    __syncthreads();                                   // the stage buffer and scales are free
  }
}

template <typename KV, int DH>
int launch(const void* const* p, const int* n, cudaStream_t stream) {
  // n: B, T, Hkv, Gq, Q, G, NCB, NSB, cmp_block, cmp_stride, sel_block,
  //    n_cmp, keys, span, HS
  const int T = n[1], Gq = n[3], Q = n[4], G = n[5], NX = n[11], keys = n[12], HS = n[14];
  const int cmp_block = n[8], cmp_stride = n[9], sel_block = n[10];
  if (Gq < 1 || HS != (Gq + RT - 1) / RT || Q < 1 || Q * min(Gq, RT) > RT ||
      (HS > 1 && Q != 1) || G * Q < T || (G - 1) * Q >= T ||
      NX < 1 || NX > NXMAX || 2 * NX * RT > Walk<KV, DH>::SCRATCH || keys < UK ||
      keys > KMAX || keys % UK || cmp_block < 1 || cmp_stride < 1 || sel_block < 1 ||
      n[13] < ((keys - 1) * cmp_stride + cmp_block + sel_block - 2) / sel_block + 1)
    return (int)cudaErrorInvalidValue;
  // every stage of the p_slc merge holds the chunks one selection block needs
  const int span = n[13], cap = (KMAX + 4) / span;
  auto j0_of = [&](int x) { return x * keys * cmp_stride / sel_block; };
  for (int xa = 1, xs = 0; xa < NX; ++xa) {
    while (j0_of(xa) - j0_of(xs) >= span) ++xs;
    if (xa - xs >= cap) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(Smem<KV, DH>);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        routing_kernel<KV, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(G * HS * NX, n[2], n[0]);
  routing_kernel<KV, DH><<<grid, NT, smem, stream>>>(
      (const float*)p[0], (const KV*)p[1], (const KV*)p[2], (const int*)p[3],
      (const int*)p[4], (float*)p[5], (float*)p[6], (float*)p[7], (float*)p[8],
      (float*)p[9], (int*)p[10], T, n[2], Gq, Q, G, n[6], n[7], cmp_block, cmp_stride,
      sel_block, NX, keys, span, HS);
  return (int)cudaGetLastError();
}

}  // namespace

// the head dims with template instances
#define HEAD_DIMS(X) X(64) X(128) X(160) X(192) X(256)

// ptrs: q, k_cmp, v_cmp, positions, ncb_valid, o_cmp, p_slc, part_ml,
//       part_acc, part_sc, tickets                          (11 pointers)
// ints: B, T, Hkv, Gq, Q, G, NCB, NSB, cmp_block, cmp_stride, sel_block,
//       n_cmp, keys, span, HS  (15 ints; Q, G and HS are ops.py:query_groups,
//       n_cmp, keys and span ops.py:routing_plan)
// kv_dtype: 0 = float32, 1 = bfloat16. DH: 64, 128, 160, 192 or 256.
// Tickets are zero before the first call. Returns the cudaError_t of the launch.
extern "C" int routing_launch(const void* const* ptrs, const int* ints, int kv_dtype, int DH,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define X(D)                                                           \
  if (kv_dtype == 0 && DH == D) return launch<float, D>(ptrs, ints, s); \
  if (kv_dtype == 1 && DH == D) return launch<__nv_bfloat16, D>(ptrs, ints, s);
  HEAD_DIMS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the instance (kv_dtype, DH), or -1.
extern "C" int routing_smem_bytes(int kv_dtype, int DH) {
#define X(D)                                                             \
  if (kv_dtype == 0 && DH == D) return (int)sizeof(Smem<float, D>);       \
  if (kv_dtype == 1 && DH == D) return (int)sizeof(Smem<__nv_bfloat16, D>);
  HEAD_DIMS(X)
#undef X
  return -1;
}
