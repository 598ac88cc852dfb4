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
// Design. One CTA per (tree query t, kv head h, batch b) holds the Gq query
// rows of that head, so the GQA sum happens inside the CTA (no atomics).
// Visibility is a prefix of the cmp blocks (block ends grow with the
// index), so the CTA walks only the visible blocks. Two passes: the
// logits of all visible blocks go to shared memory (Gq x NCB floats, 8 KB
// at NCB=512), then max / sum per row and one normalization, then the
// output and the scores are read from the normalized probabilities. The
// TPU kernel's (R, NSB) score accumulator does not fit a CTA at long
// context; here no such accumulator exists: the overlap matrix M is banded
// (a cmp block of length l and stride d overlaps at most ceil(l/l')+1
// selection blocks), so each selection block's score is a short sum whose
// overlap weights come from the geometry, never from a loaded matrix.
//
// Bound on this card: operations. The work is 4*DH flops per visible
// (query row, cmp block) pair at the f32 rate (CUDA cores); the bytes (q,
// the visible compressed K/V of each head once, o_cmp and p_slc) take
// about a third of that time at the full-width ssv-nsa-1b shapes. FMA on
// CUDA cores with f32 accumulation; wgmma/TMA are left for a later change.
// Head dim 64 and 128 are template instances (shared memory is sized at
// launch: Gq*(NCB + DH) floats, opted in above 48 KB).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

#include "online_softmax.cuh"

namespace {

using online_softmax::NT;
using online_softmax::NW;
using online_softmax::warp_max;
using online_softmax::warp_sum;

constexpr int GQ_MAX = 8;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename KV, int DH>
__global__ void __launch_bounds__(NT) routing_kernel(
    const float* __restrict__ q, const KV* __restrict__ kc,
    const KV* __restrict__ vc, const int* __restrict__ pos,
    const int* __restrict__ ncb_valid, float* __restrict__ o,
    float* __restrict__ p_slc, int T, int Hkv, int Gq, int NCB, int NSB,
    int cmp_block, int cmp_stride, int sel_block) {
  constexpr int E = DH / 32;        // head-dim elements per lane in pass 1
  extern __shared__ float smem[];
  float* sp = smem;                 // [Gq][NCB] logits, then probabilities
  float* sq = smem + (size_t)Gq * NCB;  // [Gq][DH]
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * Gq;

  for (int i = tid; i < Gq * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    sq[i] = q[(((size_t)b * T + t) * Hq + h * Gq + g) * DH + d];
  }
  // cmp block n is visible iff n*stride + cmp_block - 1 <= p and
  // n < ncb_valid: a prefix [0, nvis) of the blocks
  const int p = pos[b * T + t];
  int nvis = (p - cmp_block + 1 >= 0) ? (p - cmp_block + 1) / cmp_stride + 1 : 0;
  nvis = max(0, min(nvis, min(ncb_valid[b], NCB)));
  __syncthreads();

  // pass 1: logits, one warp per cmp block (lanes split the head dim)
  for (int n = warp; n < nvis; n += NW) {
    const KV* kr = kc + (((size_t)b * NCB + n) * Hkv + h) * DH + E * lane;
    float kf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kf[e] = ld(kr + e);
    for (int g = 0; g < Gq; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += sq[g * DH + E * lane + e] * kf[e];
      s = warp_sum(s);
      if (lane == 0) sp[(size_t)g * NCB + n] = s;
    }
  }
  __syncthreads();

  // row softmax over the visible blocks (rows with none stay all-zero)
  for (int g = warp; g < Gq; g += NW) {
    float* row = sp + (size_t)g * NCB;
    float m = -INFINITY;
    for (int n = lane; n < nvis; n += 32) m = fmaxf(m, row[n]);
    m = warp_max(m);
    float l = 0.f;
    for (int n = lane; n < nvis; n += 32) {
      const float e = expf(row[n] - m);
      row[n] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int n = lane; n < nvis; n += 32) row[n] = row[n] / l;
  }
  __syncthreads();

  // o_cmp: thread per (row, dim), coalesced over the head dim
  for (int i = tid; i < Gq * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    const float* row = sp + (size_t)g * NCB;
    const KV* vb = vc + ((size_t)b * NCB * Hkv + h) * DH + d;
    float acc = 0.f;
    for (int n = 0; n < nvis; ++n) acc += row[n] * ld(vb + (size_t)n * Hkv * DH);
    o[(((size_t)b * T + t) * Hq + h * Gq + g) * DH + d] = acc;
  }

  // p_slc[j] = sum_n (sum_g p[g][n]) * overlap(n, j) / cmp_block over the
  // few cmp blocks that overlap selection block j
  for (int j = tid; j < NSB; j += NT) {
    const int lo_tok = j * sel_block, hi_tok = (j + 1) * sel_block;
    const int first = lo_tok - cmp_block + 1;
    const int n_lo = first <= 0 ? 0 : (first + cmp_stride - 1) / cmp_stride;
    const int n_hi = min(nvis - 1, (hi_tok - 1) / cmp_stride);
    float acc = 0.f;
    for (int n = n_lo; n <= n_hi; ++n) {
      const int ov = min(n * cmp_stride + cmp_block, hi_tok) - max(n * cmp_stride, lo_tok);
      if (ov <= 0) continue;
      float P = 0.f;
      for (int g = 0; g < Gq; ++g) P += sp[(size_t)g * NCB + n];
      acc += P * ((float)ov / (float)cmp_block);
    }
    p_slc[(((size_t)b * T + t) * Hkv + h) * NSB + j] = acc;
  }
}

template <typename KV, int DH>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           const void* ncb_valid, void* o, void* p_slc, int B, int T, int Hkv,
           int Gq, int NCB, int NSB, int cmp_block, int cmp_stride,
           int sel_block, cudaStream_t stream) {
  const size_t smem = (size_t)Gq * (NCB + DH) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        routing_kernel<KV, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(T, Hkv, B);
  routing_kernel<KV, DH><<<grid, NT, smem, stream>>>(
      (const float*)q, (const KV*)kc, (const KV*)vc, (const int*)pos,
      (const int*)ncb_valid, (float*)o, (float*)p_slc, T, Hkv, Gq, NCB, NSB,
      cmp_block, cmp_stride, sel_block);
  return (int)cudaGetLastError();
}

}  // namespace

#define ROUTING_ARGS q, kc, vc, pos, ncb_valid, o, p_slc, B, T, Hkv, Gq, NCB, \
    NSB, cmp_block, cmp_stride, sel_block, s

// kv_dtype: 0 = float32, 1 = bfloat16. DH: 64 or 128. Returns the
// cudaError_t of the launch.
extern "C" int routing_launch(const void* q, const void* kc, const void* vc,
                              const void* pos, const void* ncb_valid, void* o,
                              void* p_slc, int B, int T, int Hkv, int Gq,
                              int NCB, int NSB, int cmp_block, int cmp_stride,
                              int sel_block, int kv_dtype, int DH, void* stream) {
  if (Gq < 1 || Gq > GQ_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == 0 && DH == 64) return launch<float, 64>(ROUTING_ARGS);
  if (kv_dtype == 0 && DH == 128) return launch<float, 128>(ROUTING_ARGS);
  if (kv_dtype == 1 && DH == 64) return launch<__nv_bfloat16, 64>(ROUTING_ARGS);
  if (kv_dtype == 1 && DH == 128) return launch<__nv_bfloat16, 128>(ROUTING_ARGS);
  return (int)cudaErrorInvalidValue;
}
