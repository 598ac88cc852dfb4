// The online-softmax key tile shared by the flash tree-verify kernel
// (flash_verify.cu) and the fused NSA verify kernel (nsa_verify.cu), and the
// warp reductions the routing kernel (routing.cu) uses too.
//
// A CTA of NT threads holds `rows` query rows (q in shared memory, f32) and
// walks key tiles of TK keys. Per tile: K/V rows are read in their own dtype
// with 16-byte loads and converted to f32 in registers, the logits of the
// visible (row, key) pairs are dotted on CUDA cores, the running max m and
// sum l of each row (shared memory, one pair of arrays per softmax state)
// are updated, and the output accumulator (registers; thread tid holds
// elements tid + j*NT of the (ROWS, DH) tile) is rescaled and advanced. A
// fully masked tile adds exactly 0 and leaves the running max unchanged.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace online_softmax {

constexpr int NT = 128;                // threads per CTA
constexpr int NW = NT / 32;
constexpr int TK = 64;                 // keys per tile (two per lane below)
constexpr float NEG = -1e30f;          // initial running max

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of K/V -> f32 in registers.
template <typename KV> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <int ROWS, int DH>
struct Tile {
  float q[ROWS][DH];
  float k[TK][DH + 1];                 // +1: conflict-free row-wise dots
  float v[TK][DH];
  float s[ROWS][TK];                   // logits, then probabilities
  float alpha[ROWS];
};

// One tile of nk <= TK keys for rows [0, rows). key_off(kk) -> element
// offset of key kk's K/V row from kbase / vbase, or -1 to read zeros;
// mask(r, kk) -> row r may attend key kk. m, l: this state's running max and
// sum per row (shared memory); acc: its output accumulator. K/V rows must be
// 16-byte aligned (the wrappers check the base pointers).
template <int ROWS, int DH, typename KV, typename KeyOff, typename Mask>
__device__ __forceinline__ void tile(Tile<ROWS, DH>& t, float* m, float* l,
                                     float (&acc)[ROWS * DH / NT],
                                     const KV* __restrict__ kbase,
                                     const KV* __restrict__ vbase, int nk,
                                     int rows, KeyOff key_off, Mask mask) {
  constexpr int V = Vec<KV>::N;
  constexpr int OUT_PER_T = ROWS * DH / NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();                     // previous tile's smem reads are done
  for (int i = tid; i < TK * (DH / V); i += NT) {
    const int kk = i / (DH / V), c = (i % (DH / V)) * V;
    const long off = kk < nk ? key_off(kk) : -1L;
    float kf[V], vf[V];
    if (off >= 0) {
      Vec<KV>::load(kbase + off + c, kf);
      Vec<KV>::load(vbase + off + c, vf);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      t.k[kk][c + e] = kf[e];
      t.v[kk][c + e] = vf[e];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * TK; i += NT) {
    const int r = i / TK, kk = i % TK;
    float s = -INFINITY;
    if (kk < nk && mask(r, kk)) {
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) a += t.q[r][d] * t.k[kk][d];
      s = a;
    }
    t.s[r][kk] = s;
  }
  __syncthreads();
  for (int r = warp; r < rows; r += NW) {
    const float s0 = t.s[r][lane], s1 = t.s[r][lane + 32];
    const float mt = warp_max(fmaxf(s0, s1));
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, mt);        // masked keys never raise it
    const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
    const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
    t.s[r][lane] = p0;
    t.s[r][lane + 32] = p1;
    const float psum = warp_sum(p0 + p1);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      t.alpha[r] = alpha;
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OUT_PER_T; ++j) {
    const int i = tid + j * NT;
    const int r = i / DH, d = i % DH;
    if (r < rows) {
      float a = acc[j] * t.alpha[r];
      for (int kk = 0; kk < nk; ++kk) a += t.s[r][kk] * t.v[kk][d];
      acc[j] = a;
    }
  }
}

}  // namespace online_softmax
