// Flash tree-verification kernel for Hopper (sm_90a): dense attention of
// the T draft-tree queries over the committed prefix plus the draft tokens.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash/kernel.py:18
// (make_kernel) + :69 (build_flash_verify), driven by
// src/repro/kernels/flash/ops.py:26 (flash_verify). It serves the dense
// draft's verify passes and the dense-verification target (the paper's
// dense baseline).
//
// Contract (same as flash_verify): q (B,T,Hq,DH) f32, pre-scaled by
// 1/sqrt(DH) and rope'd; k/v cache (B,S,Hkv,DH) and k/v draft (B,T,Hkv,DH)
// in f32 or bf16; positions (B,T) and prefix_len (B,) int32 on the device
// (one length per row, no host sync); dmask (B,T*Gq,T) int32 (tree mask,
// causality and window distance, built by the wrapper). Output (B,T,Hq,DH)
// f32: per query row, one softmax over [prefix keys | draft keys] with
// prefix mask kpos < prefix_len & kpos <= position (& kpos > position -
// window), 0 where a row sees no key.
//
// Design. The TPU kernel walks the cache tiles of one (b, kv head) in one
// sequential grid dimension; here that would be B*Hkv = 8 CTAs on 132 SMs.
// So the work is split three ways: grid.z = (b, kv head), grid.y = tiles
// of RT = 16 query rows (R = T*Gq rows: 31 for the draft, 124 for a Gq-4
// target), grid.x = splits of KS cache keys (512; more past 255 splits,
// ops.py:split_keys, so the merge table fits) plus one split for the draft
// tokens. A split holds the keys below prefix_len, at or below the deepest
// row and inside the shallowest row's window; a split with none (past the
// prefix, before the window) exits at once. The others walk their keys in
// units of 16 (online_softmax.cuh, shared with nsa_verify.cu: four warps
// each with its own online softmax, K/V copied with cp.async into
// per-warp rings, dots on tensor cores for bf16 K/V) and write their
// partial (m, l, acc) to scratch. The last CTA of each (b, head, row tile)
// to finish (an atomic ticket, reset by that CTA for the next call)
// recomputes on the device which splits held keys, reads their m and l
// into a table in shared memory (one pass over all threads), and then
// every thread sums its output elements over the live splits, all loads
// issued independently, in split order; it writes each output row once.
// The tickets belong to one stream (the wrapper keeps a buffer per device
// and stream): calls on one stream never overlap, so a call always finds
// them at 0.
//
// Bound on this card: bytes. With the dots on tensor cores (bf16), the
// flops of the visible (row, key) pairs take less time than reading each
// K/V row of the prefix and draft once (plus q, out, positions and mask).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "online_softmax.cuh"

namespace {

using namespace online_softmax;

template <typename KV, int DH>
struct Smem {
  Walk<KV, DH> wk;                     // rings, q, warp merge; merge tables
  int pos[RT];
  int last;
};

template <typename KV, int DH>
__global__ void __launch_bounds__(NT, 1) flash_verify_kernel(
    const float* __restrict__ q,                                  // (B,T,Hq,DH)
    const KV* __restrict__ kcache, const KV* __restrict__ vcache, // (B,S,Hkv,DH)
    const KV* __restrict__ kdr, const KV* __restrict__ vdr,       // (B,T,Hkv,DH)
    const int* __restrict__ pos,                                  // (B,T)
    const int* __restrict__ prefix_len,                           // (B,)
    const int* __restrict__ dmask,                                // (B,T*Gq,T)
    float* __restrict__ part_ml,       // (B*Hkv, NRT, NX, RT, 2): m, l
    float* __restrict__ part_acc,      // (B*Hkv, NRT, NX, RT, DH)
    int* __restrict__ tickets,         // (B*Hkv, NRT), all 0 between calls
    float* __restrict__ out,                                      // (B,T,Hq,DH)
    int T, int S, int Hkv, int Gq, int window, int KS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<KV, DH>& sm = *reinterpret_cast<Smem<KV, DH>*>(smem_raw);
  const int x = blockIdx.x, rt = blockIdx.y, z = blockIdx.z;
  const int NX = gridDim.x, NRT = gridDim.y, NS = NX - 1;
  const int b = z / Hkv, h = z % Hkv;
  const int tid = threadIdx.x;
  const int R = T * Gq, Hq = Hkv * Gq;
  const int r0 = rt * RT, rows = min(RT, R - r0);
  const int plen = prefix_len[b];

  for (int r = tid; r < RT; r += NT) sm.pos[r] = r < rows ? pos[b * T + (r0 + r) / Gq] : 0;
  __syncthreads();
  int min_pos = sm.pos[0], max_pos = sm.pos[0];
  for (int r = 1; r < rows; ++r) {
    min_pos = min(min_pos, sm.pos[r]);
    max_pos = max(max_pos, sm.pos[r]);
  }
  // cache split xs: keys [lo, hi) below prefix_len, at or below the deepest
  // row, inside the shallowest row's window
  auto split = [&](int xs) {
    const int lo = window > 0 ? max(xs * KS, min_pos - window + 1) : xs * KS;
    return make_int2(lo, min(min(xs * KS + KS, S), min(plen, max_pos + 1)));
  };
  const int2 span = x < NS ? split(x) : make_int2(0, 0);
  const int lo = span.x, hi = span.y;
  const size_t slab0 = ((size_t)z * NRT + rt) * NX;               // this tile's splits
  const size_t kv_row = (size_t)Hkv * DH;

  if (x == NS || lo < hi) {
    // q, loaded while the first units' copies are in flight
    auto load_q = [&]() {
      for (int i = tid; i < RT * DH; i += NT) {
        const int r = i / DH, d = i % DH;
        const int gr = r0 + r, t = gr / Gq, head = h * Gq + gr % Gq;
        sm.wk.q.set(r, d, r < rows ? q[(((size_t)b * T + t) * Hq + head) * DH + d] : 0.f);
      }
      __syncthreads();
    };
    State<DH, 2> st;
    st.init();
    if (x < NS) {
      const KV* kb = kcache + (size_t)b * S * kv_row + (size_t)h * DH;
      const KV* vb = vcache + (size_t)b * S * kv_row + (size_t)h * DH;
      walk(sm.wk, st, (hi - lo + UK - 1) / UK, rows, kcache,
           [&](int u) { return lo + u * UK; },          // first key of the unit
           [](int) { return true; },
           [&](int) { return Rows<KV>{kb, vb}; },
           [&](int k0, int kk) { return k0 + kk < hi ? (k0 + kk) * (int)kv_row : -1; },
           [&](int k0) { return min(UK, hi - k0); },
           [&](int k0, int r, int kk) {
             const int kp = k0 + kk;
             return kp <= sm.pos[r] && (window <= 0 || kp > sm.pos[r] - window);
           }, load_q);
    } else {
      // ---- the draft tokens under the (row-expanded) draft mask
      const KV* kd = kdr + (size_t)b * T * kv_row + (size_t)h * DH;
      const KV* vd = vdr + (size_t)b * T * kv_row + (size_t)h * DH;
      const int* dm = dmask + ((size_t)b * R + r0) * T;
      walk(sm.wk, st, (T + UK - 1) / UK, rows, kcache,
           [&](int u) { return u * UK; },               // first draft token
           [](int) { return true; },
           [&](int) { return Rows<KV>{kd, vd}; },
           [&](int d0, int kk) { return d0 + kk < T ? (d0 + kk) * (int)kv_row : -1; },
           [&](int d0) { return min(UK, T - d0); },
           [&](int d0, int r, int kk) { return dm[(size_t)r * T + d0 + kk] > 0; }, load_q);
    }
    cta_partial(sm.wk, st, part_ml + (slab0 + x) * RT * 2, part_acc + (slab0 + x) * RT * DH);
  }

  // ---- the last CTA of (b, h, row tile) merges the live splits
  if (!last_of(tickets + (size_t)z * NRT + rt, NX, &sm.last)) return;
  float* sc = sm.wk.scratch();                       // [NX][RT]: m, then scale
  float* xl = sc + NX * RT;                          // [NX][RT]: l
  for (int i = tid; i < NX * RT; i += NT) {
    const int xs = i / RT;
    const int2 sp = xs < NS ? split(xs) : make_int2(0, 0);
    const bool live = xs == NS || sp.x < sp.y;
    sc[i] = live ? __ldcg(part_ml + (slab0 + xs) * RT * 2 + 2 * (i % RT)) : NEG;
    xl[i] = live ? __ldcg(part_ml + (slab0 + xs) * RT * 2 + 2 * (i % RT) + 1) : 0.f;
  }
  __syncthreads();
  for (int r = tid >> 5; r < RT; r += NW) merge_scales(sc, xl, r, 0, NX);
  __syncthreads();
  for (int i = tid; i < rows * DH / 4; i += NT) {
    const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
    const float4 a = merge_acc(sc, r, part_acc + (slab0 * RT + r) * DH + d, (size_t)RT * DH,
                               0, NX);
    const int gr = r0 + r, t = gr / Gq, head = h * Gq + gr % Gq;
    *reinterpret_cast<float4*>(out + (((size_t)b * T + t) * Hq + head) * DH + d) = a;
  }
}

template <typename KV, int DH>
int launch(const void* const* p, const int* n, cudaStream_t stream) {
  // n: B, T, S, Hkv, Gq, window, DH, KS
  const int B = n[0], T = n[1], S = n[2], Hkv = n[3], Gq = n[4], KS = n[7];
  const int NS = (S + KS - 1) / KS, NRT = (T * Gq + RT - 1) / RT;
  if (2 * (NS + 1) * RT > Walk<KV, DH>::SCRATCH) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Smem<KV, DH>);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_verify_kernel<KV, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(NS + 1, NRT, B * Hkv);
  flash_verify_kernel<KV, DH><<<grid, NT, smem, stream>>>(
      (const float*)p[0], (const KV*)p[1], (const KV*)p[2], (const KV*)p[3],
      (const KV*)p[4], (const int*)p[5], (const int*)p[6], (const int*)p[7],
      (float*)p[8], (float*)p[9], (int*)p[10], (float*)p[11],
      T, S, Hkv, Gq, n[5], KS);
  return (int)cudaGetLastError();
}

}  // namespace

// the head dims with template instances
#define HEAD_DIMS(X) X(64) X(80) X(96) X(128) X(160) X(192) X(256)

// ptrs: q, k_cache, v_cache, k_draft, v_draft, positions, prefix_len, dmask,
//       part_ml, part_acc, tickets, out                       (12 pointers)
// ints: B, T, S, Hkv, Gq, window, DH, KS                      (8 ints)
// kv_dtype: 0 = float32, 1 = bfloat16. DH: 64, 80, 96, 128, 160, 192 or
// 256 (the drafts' head dims). Scratch sizes (from NS = ceil(S/KS), NX = NS + 1, NRT = ceil(T*Gq/16)): part_ml
// B*Hkv*NRT*NX*16*2 floats, part_acc B*Hkv*NRT*NX*16*DH floats, tickets
// B*Hkv*NRT ints, zero before the first call. Returns the cudaError_t of
// the launch.
extern "C" int flash_verify_launch(const void* const* ptrs, const int* ints,
                                   int kv_dtype, void* stream) {
  const int DH = ints[6];
  if (ints[0] < 1 || ints[1] < 1 || ints[2] < 1 || ints[4] < 1 || ints[7] < 1)
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
extern "C" int flash_verify_smem_bytes(int kv_dtype, int DH) {
#define X(D)                                                             \
  if (kv_dtype == 0 && DH == D) return (int)sizeof(Smem<float, D>);       \
  if (kv_dtype == 1 && DH == D) return (int)sizeof(Smem<__nv_bfloat16, D>);
  HEAD_DIMS(X)
#undef X
  return -1;
}
