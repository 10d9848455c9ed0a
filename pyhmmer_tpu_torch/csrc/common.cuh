// Shared helpers for the port's kernels (msv.cu, vit.cu, fwd.cu, rows.cu).
//
// Layout shared by the kernels: one warp scores one (profile, target)
// pair.  The model's Mk = 32 * S slots are cut into 32 contiguous
// stripes of S slots, lane l owning slots l*S .. l*S+S-1 in registers, so
// the row-to-row dependency on slot k-1 stays inside a lane except at a
// stripe's first slot, which takes the previous lane's last slot with one
// __shfl_up_sync.  Per-slot tables are stored stripe-interleaved,
// [..., S, 32] with element (j, l) holding slot l*S + j, so the warp's
// read of one j is 32 consecutive elements.  S is a template parameter so
// the stripe lives in registers; PYHMMER_STRIPES lists the compiled
// widths (ops/batch.py:STRIPES must match).  msv.cu re-stripes its table
// in shared memory to give narrow models 16 lanes and two targets a warp.
//
// The wide route, for models wider than 32 * 128 = 4,096 slots (any width
// the port accepts, up to the 100,000 residues of a phmmer query): one CTA
// of CTA_THREADS threads scores one (profile, target) pair, thread t owning
// the contiguous run of SPT = Mk / CTA_THREADS slots t*SPT .. t*SPT+SPT-1
// (Mk is a runtime argument, a multiple of CTA_THREADS: ops/batch.py:
// kernel_width).  The tables are unstriped ([P, Kp, Mk] MSV words, [P, Kp,
// 2, Mk] emissions, [P, 8, Mk] transitions).  A row's cells live in a
// global scratch buffer of two rows a CTA, stored [SPT][CTA_THREADS] so
// the threads' accesses to one position j are contiguous; a grid of at
// most a few CTAs a SM walks over the pairs (msv.cu, vit.cu, fwd.cu:
// *_cta_kernel).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PYHMMER_STRIPES(X) \
  X(1) X(2) X(3) X(4) X(6) X(8) X(12) X(16) X(24) X(32) X(48) X(64) \
      X(96) X(128)

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEGMASS = -1e30f;
constexpr int WARPS_PER_BLOCK = 4;
// the wide route (ops/batch.py:CTA_THREADS must match)
constexpr int CTA_THREADS = 512;
constexpr int CTA_WARPS = CTA_THREADS / 32;

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}
