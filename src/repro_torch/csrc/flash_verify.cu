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
// of RT query rows (R = T*Gq rows: 31 for the draft, 124 for a Gq-4
// target), grid.x = splits of KS cache keys plus one split for the draft
// tokens. Each CTA keeps an online softmax (running max and sum per row in
// shared memory, the output accumulator in registers) over its key tiles,
// reading only keys below prefix_len (and inside the window), K/V in their
// own dtype with 16-byte loads, converted to f32 in registers (the tile step
// is online_softmax.cuh, shared with nsa_verify.cu). It writes
// its partial (m, l, acc) to scratch; the last CTA of each (b, head, row
// tile) to finish (an atomic ticket, reset by that CTA for the next call)
// merges the partials and writes each output row once. The tickets belong
// to one stream (the wrapper keeps a buffer per device and stream): calls on
// one stream never overlap, so a call always finds them at 0.
//
// Bound on this card: operations at the draft's and target's shapes. The
// flops are 4*DH per visible (query row, key) pair at the f32 rate (CUDA
// cores); the bytes (each K/V row of the prefix and draft once, q, out,
// positions and mask) take about a quarter of that time at prefix 4096.
// FMA on CUDA cores with f32 accumulation; wgmma and TMA are left for a
// later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "online_softmax.cuh"

namespace {

using namespace online_softmax;

constexpr int RT = 32;                 // query rows per CTA

template <int DH>
struct Smem {
  Tile<RT, DH> t;                      // q, K/V tile, logits
  float m[RT];
  float l[RT];
  int pos[RT];
  int last;
};

template <typename KV, int DH>
__global__ void __launch_bounds__(NT) flash_verify_kernel(
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
  constexpr int OUT_PER_T = RT * DH / NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  const int x = blockIdx.x, rt = blockIdx.y, z = blockIdx.z;
  const int NX = gridDim.x, NRT = gridDim.y, NS = NX - 1;
  const int b = z / Hkv, h = z % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = T * Gq, Hq = Hkv * Gq;
  const int r0 = rt * RT, rows = min(RT, R - r0);
  const int plen = prefix_len[b];

  for (int r = tid; r < RT; r += NT) {
    sm.pos[r] = r < rows ? pos[b * T + (r0 + r) / Gq] : 0;
    sm.m[r] = NEG;
    sm.l[r] = 0.f;
  }
  for (int i = tid; i < rows * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int gr = r0 + r, t = gr / Gq, head = h * Gq + gr % Gq;
    sm.t.q[r][d] = q[(((size_t)b * T + t) * Hq + head) * DH + d];
  }
  __syncthreads();
  int min_pos = sm.pos[0], max_pos = sm.pos[0];
  for (int r = 1; r < rows; ++r) {
    min_pos = min(min_pos, sm.pos[r]);
    max_pos = max(max_pos, sm.pos[r]);
  }

  float acc[OUT_PER_T];
#pragma unroll
  for (int j = 0; j < OUT_PER_T; ++j) acc[j] = 0.f;
  const size_t kv_row = (size_t)Hkv * DH;

  if (x < NS) {
    // ---- cache split x: keys [x*KS, x*KS + KS) below prefix_len, at or
    // below the deepest row, inside the shallowest row's window
    int lo = x * KS;
    if (window > 0) lo = max(lo, min_pos - window + 1);
    const int hi = min(min(x * KS + KS, S), min(plen, max_pos + 1));
    const KV* kb = kcache + (size_t)b * S * kv_row + (size_t)h * DH;
    const KV* vb = vcache + (size_t)b * S * kv_row + (size_t)h * DH;
    for (int k0 = lo; k0 < hi; k0 += TK) {
      tile(sm.t, sm.m, sm.l, acc, kb, vb, min(TK, hi - k0), rows,
               [&](int kk) -> long { return (long)(k0 + kk) * (long)kv_row; },
               [&](int r, int kk) {
                 const int kp = k0 + kk;
                 return kp <= sm.pos[r] && (window <= 0 || kp > sm.pos[r] - window);
               });
    }
  } else {
    // ---- the draft tokens under the (row-expanded) draft mask
    const KV* kd = kdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const KV* vd = vdr + (size_t)b * T * kv_row + (size_t)h * DH;
    const int* dm = dmask + ((size_t)b * R + r0) * T;
    for (int k0 = 0; k0 < T; k0 += TK) {
      tile(sm.t, sm.m, sm.l, acc, kd, vd, min(TK, T - k0), rows,
               [&](int kk) -> long { return (long)(k0 + kk) * (long)kv_row; },
               [&](int r, int kk) { return dm[(size_t)r * T + k0 + kk] > 0; });
    }
  }

  // ---- partials of this split
  __syncthreads();
  const size_t pbase = ((size_t)z * NRT + rt) * NX + x;           // (.., RT) slab
  float* ml = part_ml + pbase * RT * 2;
  float* pa = part_acc + pbase * RT * DH;
  for (int r = tid; r < rows; r += NT) {
    ml[2 * r] = sm.m[r];
    ml[2 * r + 1] = sm.l[r];
  }
#pragma unroll
  for (int j = 0; j < OUT_PER_T; ++j) {
    const int i = tid + j * NT;
    const int r = i / DH;
    if (r < rows && sm.l[r] > 0.f) pa[i] = acc[j];
  }

  // ---- the last CTA of (b, h, row tile) merges the NX partials
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)z * NRT + rt;
  if (tid == 0) sm.last = atomicAdd(ticket, 1) == NX - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  const size_t slab0 = ((size_t)z * NRT + rt) * NX;
  for (int r = warp; r < rows; r += NW) {
    float M = NEG;
    for (int s = lane; s < NX; s += 32) M = fmaxf(M, __ldcg(part_ml + ((slab0 + s) * RT + r) * 2));
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < NX; s += 32) {
      const float* p = part_ml + ((slab0 + s) * RT + r) * 2;
      const float ls = __ldcg(p + 1);
      if (ls > 0.f) L += ls * expf(__ldcg(p) - M);
    }
    L = warp_sum(L);
    if (lane == 0) {
      sm.m[r] = M;
      sm.l[r] = L;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const float M = sm.m[r], L = sm.l[r];
    float a = 0.f;
    if (L > 0.f) {
      for (int s = 0; s < NX; ++s) {
        const float* p = part_ml + ((slab0 + s) * RT + r) * 2;
        const float ls = __ldcg(p + 1);
        if (ls > 0.f)
          a += __ldcg(part_acc + ((slab0 + s) * RT + r) * DH + d) * expf(__ldcg(p) - M);
      }
      a /= fmaxf(L, 1e-30f);
    }
    const int gr = r0 + r, t = gr / Gq, head = h * Gq + gr % Gq;
    out[(((size_t)b * T + t) * Hq + head) * DH + d] = a;
  }
  if (tid == 0) *ticket = 0;           // ready for the next call
}

template <typename KV, int DH>
int launch(const void* const* p, const int* n, cudaStream_t stream) {
  // n: B, T, S, Hkv, Gq, window, DH, KS
  const int B = n[0], T = n[1], S = n[2], Hkv = n[3], Gq = n[4], KS = n[7];
  const int NS = (S + KS - 1) / KS, NRT = (T * Gq + RT - 1) / RT;
  const size_t smem = sizeof(Smem<DH>);
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

// ptrs: q, k_cache, v_cache, k_draft, v_draft, positions, prefix_len, dmask,
//       part_ml, part_acc, tickets, out                       (12 pointers)
// ints: B, T, S, Hkv, Gq, window, DH, KS                      (8 ints)
// kv_dtype: 0 = float32, 1 = bfloat16. DH: 64 or 128. Scratch sizes (from
// NS = ceil(S/KS), NX = NS + 1, NRT = ceil(T*Gq/32)): part_ml
// B*Hkv*NRT*NX*32*2 floats, part_acc B*Hkv*NRT*NX*32*DH floats, tickets
// B*Hkv*NRT ints, zero before the first call. Returns the cudaError_t of
// the launch.
extern "C" int flash_verify_launch(const void* const* ptrs, const int* ints,
                                   int kv_dtype, void* stream) {
  const int DH = ints[6];
  if (ints[0] < 1 || ints[1] < 1 || ints[2] < 1 || ints[4] < 1 || ints[7] < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == 0 && DH == 64) return launch<float, 64>(ptrs, ints, s);
  if (kv_dtype == 0 && DH == 128) return launch<float, 128>(ptrs, ints, s);
  if (kv_dtype == 1 && DH == 64) return launch<__nv_bfloat16, 64>(ptrs, ints, s);
  if (kv_dtype == 1 && DH == 128) return launch<__nv_bfloat16, 128>(ptrs, ints, s);
  return (int)cudaErrorInvalidValue;
}
