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
// of NT threads scores one (profile, target) pair, thread t owning the
// contiguous run of SPT = Mk / NT slots t*SPT .. t*SPT+SPT-1 (Mk is a
// runtime argument, a multiple of CTA_THREADS: ops/batch.py:kernel_width);
// a grid of as many CTAs as the card holds at once walks over the pairs.
// MSV (msv_cta_kernel, msv.cu) runs 256 threads a pair over 16-bit cells
// and a thread-major table of its own, the row in registers or shared
// memory, never in device memory.
//
// Forward and Viterbi (fwd_cta_kernel, vit_cta_kernel) read the pair's
// whole model every row, 40 bytes a slot (8 odds or log transitions and
// the residue's two emissions; 369 KB a row at Mk 9,216, more than L1
// holds), for about 20 floating-point operations a slot.  Their first
// version was bound by what that cost through L2: its unstriped reads
// touched 32 lines for a warp's load of one position (about 8x the
// sectors), and the row's cells went through a global scratch of two
// rows, 24 more bytes a cell.  This design is bound by each row's
// instructions and latency instead, not by bytes: about 30 instructions a
// slot a thread, then the scan's shuffles, one barrier and the warps'
// maps, with one CTA a SM; holding the transitions in shared memory (5x
// fewer L2 bytes a row) was measured and gained 0-9% (PERF.md).  A launch
// with fewer pairs than SMs leaves most of the card idle.
// The design against that:
//
// * Thread-major tables (ops/batch.py:thread_major): element (j, t) holds
//   slot t*SPT + j, a slot's eight transitions packed in two float4 and
//   its (M, I) emissions of a residue in one float2, so the CTA's load of
//   one position j is one contiguous run of 16 or 8 bytes a thread.
// * The row out of device memory: a thread only ever reads back its own
//   slots and the last slot of the thread below it, so M, I and D of its
//   run stay in registers (CtaCells<SPT, NT>) for the compiled shapes
//   PYHMMER_CTA_REGS (below: up to 5,632 slots); the thread below's last
//   cells come through one shuffle inside a warp and, across warps, from
//   lane 31's copy in shared memory, written before the row's one
//   barrier.  Past the ladder the row lives in shared memory (three
//   floats a slot, up to CTA_SMEM_SLOTS = 18,944), past that in a global
//   scratch row a CTA, each [3][SPT][NT] (CtaCells<0, NT>), so every
//   access is contiguous; the global tier (the 35,000-residue titin
//   fragment, a 100,000-residue query) moves 12 bytes a cell instead of
//   the first version's 24.
// * One barrier a row (cta_scan, below): each thread runs its slots with 0
//   entering its D chain, giving its map x -> (D leaving, E share); the
//   warps scan their threads' maps with shuffles, lane 31 publishes its
//   warp's map, and after the barrier every thread composes the warps'
//   maps itself (E, the row's scale and the D that entered it), so the
//   row's cells are stored unscaled with their local D and made true when
//   the next row reads them.  Buffers alternate by row parity.
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
// The wide-route Forward and Viterbi kernels compiled with the row in
// registers, X(threads a CTA, slots a thread) (ops/batch.py:CTA_REGS must
// match): 256 threads of 18, 20 or 22 slots, models of 4,097 to 5,632
// slots.  A thread holds 3 cells a slot beside the row's loads and scan:
// ptxas takes 252-255 registers from 18 slots on and spills from 24
// (Forward) or 26 (Viterbi); at 512 threads (128 registers a thread) it
// spills from 10 slots, and 256 threads of 18 and 20 slots beat 512 of 9
// and 10 (PERF.md; scripts/bench_torch_wide.py).  Wider models keep the
// row in shared memory (512 threads), up to CTA_SMEM_SLOTS slots: 12 bytes
// a slot, 227,328 bytes beside 1,344 of static shared memory, of a block's
// 232,448; past that in a global scratch row.  None of this pads a model:
// every width is a multiple of CTA_THREADS either way (M 4,200 runs 4,608
// slots, 5,000 runs 5,120, 9,000 runs 9,216, 35,000 runs 35,328).
#define PYHMMER_CTA_REGS(X) X(256, 18) X(256, 20) X(256, 22)
constexpr int CTA_SMEM_SLOTS = 37 * CTA_THREADS;

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

// The wide-route Forward and Viterbi kernels' arguments.
struct CtaArgs {
  const uint8_t* codes;
  int Lmax;
  const int* lens;
  const float* lm;
  const float2* emis;   // [P, Kp, spt, NT] (M, I)
  const float4* trans;  // [P, spt, 2, NT] 8 a slot
  const int* pair_p;
  const int* pair_row;
  const int* pair_out;
  int npairs, Kp, spt;
  float* out;
};

// A thread's run of cells on the wide route: M (q = 0), I (1) and the
// local D (2) of its SPT slots, in registers for SPT > 0; for SPT = 0 at
// rows[(q * spt + j) * NT], rows pointing at this thread's column of a
// [3][spt][NT] row in shared or global memory (NT threads a CTA).
template <int SPT, int NT>
struct CtaCells {
  float c[3][SPT];
  __device__ __forceinline__ CtaCells(float*, int) {}
  __device__ __forceinline__ float& at(int q, int j) { return c[q][j]; }
};

template <int NT>
struct CtaCells<0, NT> {
  float* rows;
  int spt;
  __device__ __forceinline__ CtaCells(float* r, int s) : rows(r), spt(s) {}
  __device__ __forceinline__ float& at(int q, int j) {
    return rows[(size_t)(q * spt + j) * NT];
  }
};

// The two semirings of the scan: a window of slots maps the D x entering
// it to D leaving it, x A + B (odds) or max(x + A, B) (log), and to its
// share of E.  join(x, A, B) applies a map; cat(A', A) composes the
// multipliers.
struct OddsMaps {
  static constexpr float ZERO = 0.f, ONE = 1.f;
  __device__ static __forceinline__ float join(float x, float A, float B) {
    return fmaf(x, A, B);
  }
  __device__ static __forceinline__ float cat(float Ap, float A) {
    return Ap * A;
  }
  // the warp's E share Cw + x Ww for the D x entering it, from the
  // thread's C + x W and its exclusive prefix map (Aex, Bex)
  __device__ static __forceinline__ float2 share(float C, float W, float Aex,
                                                 float Bex) {
    return make_float2(warp_sum_f(fmaf(Bex, W, C)), warp_sum_f(Aex * W));
  }
  __device__ static __forceinline__ float e_step(float E, float X,
                                                 float4 m) {
    return E + fmaf(X, m.w, m.z);
  }
};

// (Log space: W, the largest D->D sum from a window's first slot, is 0,
// and a D cell never exceeds the M cell it came from, so a window's E
// share is its largest M cell: vit.cu.)
struct MaxPlusMaps {
  static constexpr float ZERO = NEGMASS, ONE = 0.f;
  __device__ static __forceinline__ float join(float x, float A, float B) {
    return fmaxf(x + A, B);
  }
  __device__ static __forceinline__ float cat(float Ap, float A) {
    return Ap + A;
  }
  __device__ static __forceinline__ float2 share(float C, float, float,
                                                 float) {
    return make_float2(warp_max_f(C), 0.f);
  }
  __device__ static __forceinline__ float e_step(float E, float, float4 m) {
    return fmaxf(E, m.z);
  }
};

struct CtaRow {
  float E;    // the row's E
  float Xt;   // the D that entered this thread's slots
  float Xnb;  // lane 0 of a warp past the first: the D that entered the
              // thread below
};

// One row's scan on the wide route, with its one barrier: (A, B) is this
// thread's map of the D chain (0 or NEGMASS entering), C + x W its share
// of E; last its last slot's unscaled cells (M, I, local D), published by
// lane 31 for lane 0 of the next warp.  sW, s30 and sLast are this row
// parity's: each warp's map and E share, lane 30's inclusive map, lane
// 31's last cells.  The warps' maps are composed by every thread in
// order, so every thread gets the same E.
template <class R, int NW>
__device__ __forceinline__ CtaRow cta_scan(float A, float Bm, float C,
                                           float W, float4 last, float4* sW,
                                           float2* s30, float4* sLast) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float Ap = __shfl_up_sync(FULL_MASK, A, o);
    const float Bp = __shfl_up_sync(FULL_MASK, Bm, o);
    if (lane >= o) {
      Bm = R::join(Bp, A, Bm);
      A = R::cat(Ap, A);
    }
  }
  float Aex = __shfl_up_sync(FULL_MASK, A, 1);
  float Bex = __shfl_up_sync(FULL_MASK, Bm, 1);
  if (lane == 0) Aex = R::ONE, Bex = R::ZERO;
  const float2 cw = R::share(C, W, Aex, Bex);
  if (lane == 31) {
    sW[wid] = make_float4(A, Bm, cw.x, cw.y);
    sLast[wid] = last;
  }
  if (lane == 30) s30[wid] = make_float2(A, Bm);
  __syncthreads();
  float X = R::ZERO, E = R::ZERO, Xown = R::ZERO, Xpw = R::ZERO;
  // (a few warps' maps at a time: loading all 16 at once would hold 64
  // registers beside the thread's cells)
#pragma unroll 4
  for (int v = 0; v < NW; ++v) {
    if (v == wid - 1) Xpw = X;
    if (v == wid) Xown = X;
    const float4 m = sW[v];
    E = R::e_step(E, X, m);
    X = R::join(X, m.x, m.y);
  }
  CtaRow r;
  r.E = E;
  r.Xt = R::join(Xown, Aex, Bex);
  r.Xnb = R::ZERO;
  if (wid > 0) {
    const float2 m = s30[wid - 1];
    r.Xnb = R::join(Xpw, m.x, m.y);
  }
  return r;
}

// The product (odds) or sum (log) of a thread's D->D transitions over its
// slots but the last, in the order the row loop forms it; lane 0 of each
// warp past the first gets the thread below's through sPre (returned),
// with a barrier before (the previous pair's reads are done) and after.
template <class R, int NT>
__device__ __forceinline__ float cta_pre_last(const float4* TR, int n,
                                              float* sPre, float* own) {
  float pre = R::ONE;
  for (int j = 0; j + 1 < n; ++j)
    pre = R::cat(pre, __ldg(TR + (size_t)(2 * j + 1) * NT).w);
  *own = pre;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 31) sPre[wid] = pre;
  __syncthreads();
  return lane == 0 && wid > 0 ? sPre[wid - 1] : R::ONE;
}

// The grid of a kernel of nt threads a CTA and smem bytes of dynamic
// shared memory that walks over npairs pairs: as many CTAs as the card
// holds at once (the kernel's own occupancy), no more than the pairs.
template <class K>
static inline int resident_grid(K kernel, int nt, int smem, int npairs) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
  int grid = per_sm * sms;
  if (grid > npairs) grid = npairs;
  return grid < 1 ? 1 : grid;
}

// Launch a wide-route Forward or Viterbi kernel: smem bytes of dynamic
// shared memory (its row there), or scratch (a [nctas][3][Mk] row a CTA),
// on a grid of at most nctas CTAs, as many as the card holds at once.
template <class K>
static inline int cta_launch(K kernel, int nt, const CtaArgs& a,
                             float* scratch, int smem, int nctas,
                             cudaStream_t stream) {
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int grid = resident_grid(kernel, nt, smem, a.npairs);
  if (grid > nctas) grid = nctas;
  kernel<<<grid, nt, smem, stream>>>(a, scratch);
  return (int)cudaGetLastError();
}
