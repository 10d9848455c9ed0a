// MSV filter with the 2-state composition bias filter fused in.
//
// Replaces the TPU kernels pyhmmer_tpu/ops/msv_pallas.py:_msv_body2
// (profile-stacked, launched by _msv_pallas2) and _msv_body (per profile,
// launched by _msv_pallas), and the XLA scan ops/batch.py:_msv_kernel.
//
// Semantics: HMMER's uint8 MSV (p7_MSVFilter): 1/3-bit quantized costs,
// base 190, E->J wing, with the 255 saturation elided.  Outputs per
// (profile, target): dx = xJ - 190, ovf (0/1, set when xJ >= 255 - bias -
// tec, i.e. whenever the clamp could have mattered) and the bias filter's
// log score without the null term (biaslog), renormalized every 8 rows; a
// nonresidue code (odds 0) freezes the bias state.
//
// Design (Hopper).  Two kernels per launch:
//
// * msv_kernel: one warp per (profile, target) pair, or, for models of up
//   to 256 slots (S <= 8), 16 lanes per pair and two targets per warp, so
//   the per-row work that does not grow with the width is shared; lane l
//   of a pair's group holds the stripe of SL slots l*SL .. l*SL+SL-1 (SL
//   = S, or 2S with 16 lanes).  The table is stored pre-biased, w = bias
//   - cost (ops/batch.py:msv_w16), and staged in shared memory as 16-bit
//   pairs: word r of a lane holds slots r and r + SL/2 of its stripe (an
//   odd SL keeps its last slot alone in the high half of one more word),
//   so a pair's predecessor is the previous pair, the odd slot's is the
//   high half of the last pair, and only pair 0 needs one byte permute of
//   the stripe edge.  Each word is updated by two DPX
//   instructions, max(max(prev, xBv) + w, 0) =
//   __viaddmax_s16x2(__vimax_s16x2_relu(prev, xBv), w, 0), and the row
//   maximum is folded as a tree of __vimax3_s16x2_relu.  Instead of a
//   five-step shuffle reduction per row, one ballot asks whether some
//   lane's maximum exceeds xJ + tec (one packed max against xJ + tec in
//   both halves); only then (xJ is monotone, so this is exact) does
//   __reduce_max_sync give the row maximum and xJ, xB change.  The next
//   row's codes and table words are loaded before the current row's DP
//   (SL <= 32), off the dependency chain.
// * bias_kernel: the 2-state bias recurrence, one thread per pair (it is a
//   scalar recurrence), with the float operations of the fused scan in the
//   same order.
//
// * msv_cta_kernel<R, STAGED>, the wide route (models over 4,096 slots,
//   common.cuh): one CTA of MSV_CTA_THREADS = 256 threads a pair, thread
//   t owning the run of SPT = Mk / 256 slots from t * SPT as R = SPT / 2
//   words of two 16-bit cells paired as msv_kernel pairs them (word r:
//   slots r and r + R), each updated by the same two DPX instructions
//   (int32 cells would take twice the instructions the bound counts):
//   - the table is thread-major (ops/batch.py:msv_thread_major: word r
//     of thread t at position t of a row of 256 words), so a warp's load
//     of one word is 128 contiguous bytes, not 32 sectors for 64 useful
//     bytes;
//   - the row never touches device memory: the words sit in registers
//     for R in PYHMMER_MSV_CTA_REGS (Mk 4,608-12,288), else in shared
//     memory, updated in place (a word's old value is read before the
//     new one is written; 2 bytes a slot, 196 KB at Mk 100,352), and a
//     thread needs only the previous row's last word of the thread below:
//     one __shfl_up_sync inside a warp, across warps lane 31's copy in
//     shared memory, written before the row's one barrier;
//   - a thread's maximum is a tree of __vimax3_s16x2_relu, a warp votes
//     (__any_sync) whether a lane's exceeds xJ + tec and only then
//     reduces and publishes its maximum (REDUX), and the row's one
//     barrier, __syncthreads_or, tells every thread whether any warp
//     voted, so most rows need no block reduction; the edges and maxima
//     alternate by row parity;
//   - the next row's code and table words are fetched during the current
//     row, off its dependency chain: into registers on the register tier
//     (two rows an iteration, so the two sets swap roles; a third set,
//     two rows ahead, cost occupancy and gained nothing, PERF.md), with
//     cp.async into two staged rows after the cells on the shared tier
//     where the three fit (STAGED, Mk up to 38,400; past that the words
//     are loaded inside the row, which waits on L2: 2.7 against 1.4 ms
//     at Mk 35,328 x 8 pairs, PERF.md); and the grid is the kernel's own
//     occupancy (resident_grid), several CTAs a SM, so one CTA's barrier
//     hides behind another's work.
//   Stopping a pair once ovf fires (xJ only grows from there) was
//   measured and dropped: it made the launches slower, not faster
//   (PERF.md).
//
// The engine launches the long buckets' scans (a few warps each, latency
// bound) on side streams, so they overlap the short buckets.
//
// Why 16 bits cannot wrap before ovf fires: while ovf has not fired, every
// row maximum is below 255 - bias and xB = max(190, xJ) - tj is below 255,
// so every cell of the next row, max(prev, xBv) + w with w <= bias, is
// below 255 + bias <= 510, far from 32,767: the cells, row maxima, xJ and
// hence ovf are exact up to and including the row on which ovf fires.
// From there on xJ (int32) is monotone, so ovf stays set, and the engine
// ignores dx of a flagged pair (engine.py: usc = inf where ovf): there the
// 16-bit cells may wrap and dx may differ from the int32 plain version.
// xBv and xJ + tec are clamped to 32,767 before they are packed.
//
// Bound on this card: integer issue -- HMMER's 4 operations a cell take
// 2.5 DPX instructions a word of two cells (a max with xB, an add-max
// with the cost, half a three-way max of the row maximum;
// chip_smoke.py:MSV_INSNS), plus the per-row work (P * B * L * Mk
// cells); bytes are few.  The wide route
// also reads its table from L1 or L2 every row, 2 bytes a slot (the
// table, Kp x Mk x 2 bytes, is larger than shared memory).  The TPU
// kernels cover the stripe edge with a roll and padding rows; here it is one
// __shfl_up_sync and one __byte_perm per row.  cuobjdump -sass of the
// sm_90a build shows the intrinsics as DPX instructions, not emulated:
// VIADDMNMX.S16x2, VIMNMX.S16x2.RELU and VIMNMX3.S16x2.RELU in every
// msv_kernel<S> (chip_smoke.py counts them in msv_cta_kernel<R> too),
// beside REDUX.MAX.S32, VOTE.ANY and PRMT.

#include <cuda_pipeline.h>

#include <algorithm>

#include "common.cuh"

// dynamic shared memory a block may use on sm_90
constexpr int MSV_SMEM_MAX = 232448;
constexpr int BIAS_THREADS = 64;
// The wide route (ops/batch.py:MSV_CTA_THREADS and MSV_CTA_REGS must
// match): threads a pair, and the words a thread (two slots each)
// compiled with the row in registers, models of 4,608 to 12,288 slots;
// wider ones keep it in shared memory, 2 bytes a slot (200,704 bytes at
// the widest model the port accepts, Mk 100,352), beside the static
// sLast and sMax.
constexpr int MSV_CTA_THREADS = 256;
constexpr int MSV_CTA_SMEM_STATIC = 2 * 2 * (MSV_CTA_THREADS / 32) * 4;
#define PYHMMER_MSV_CTA_REGS(X)                                           \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) \
      X(21) X(22) X(23) X(24)

// Lanes per (profile, target) pair: 32 / groups_for(S).  A model of up to
// 256 slots shares a warp between two targets, 16 lanes each, so the
// per-row work that does not grow with the width (code broadcast, stripe
// edge, vote, loop) is paid once for two rows.
__host__ __device__ constexpr int groups_for(int S) { return S <= 8 ? 2 : 1; }

// The packed word r of lane l (of a group of 32 / G lanes, SL = S * G
// slots each) for residue code x: slots r and r + SL/2 of the lane's
// stripe, read from the 32-lane table g [Kp][S][32] (slot k at
// (k % S, k / S)); for odd SL, word SL/2 holds the last slot in its high
// half and -32768 in its low half, which the clamp at 0 keeps at 0.
template <int S, int SL>
__device__ __forceinline__ uint32_t pair_word(const int16_t* g, int x, int r,
                                              int l) {
  const int16_t* row = g + (size_t)x * S * 32;
  auto slot = [&](int j) {
    const int k = l * SL + j;
    return (uint32_t)(uint16_t)row[(k % S) * 32 + k / S];
  };
  if (r < SL / 2) return slot(r) | (slot(r + SL / 2) << 16);
  return 0x8000u | (slot(SL - 1) << 16);
}

// the 16-bit maximum of n packed words, folded as a tree of 3-way maxima
template <int N>
__device__ __forceinline__ uint32_t fold_max(const uint32_t* v) {
  if constexpr (N == 1) {
    return v[0];
  } else if constexpr (N == 2) {
    return __vimax_s16x2_relu(v[0], v[1]);
  } else {
    constexpr int A = N / 3, B = (N - A) / 2;
    return __vimax3_s16x2_relu(fold_max<A>(v), fold_max<B>(v + A),
                               fold_max<N - A - B>(v + A + B));
  }
}

template <int S>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
msv_kernel(const uint8_t* __restrict__ codes, int Lmax,
           const int* __restrict__ lens,
           const int16_t* __restrict__ w16,  // [P, Kp, S, 32] bias - cost
           const float* __restrict__ scal,   // [P, 4] bias, tec, tbm, -
           const float* __restrict__ tjb,    // [B]
           int B, int Kp, int Ks, float* __restrict__ dx,
           float* __restrict__ ovf) {
  constexpr int G = groups_for(S);  // targets per warp
  constexpr int W = 32 / G;         // lanes per target
  constexpr int SL = S * G;         // slots per lane
  constexpr int H = SL / 2;
  constexpr bool ODD = (SL & 1) != 0;
  constexpr int R = H + (ODD ? 1 : 0);
  constexpr bool PREFETCH = R <= 16;
  // codes >= Ks (only at S = 128, where Kp rows do not fit) read global
  constexpr bool SPILL = S >= 128;
  // [Ks][R][32]: each group's W-lane words, repeated for every group, so
  // the groups' reads of two table rows fall on distinct banks
  extern __shared__ __align__(16) uint32_t tab[];
  const int p = blockIdx.y;
  const int16_t* g = w16 + (size_t)p * Kp * S * 32;
  for (int t = threadIdx.x; t < Ks * R * 32; t += blockDim.x)
    tab[t] = pair_word<S, SL>(g, t / (R * 32), (t >> 5) % R, t % W);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int hl = lane % W;  // lane within the target's group
  const int b0 = (blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5)) * G;
  if (b0 >= B) return;  // the whole warp leaves together
  const int b = b0 + lane / W;
  const bool valid = b < B;

  const int bias = (int)scal[p * 4 + 0];
  const int tec = (int)scal[p * 4 + 1];
  const int tbm = (int)scal[p * 4 + 2];
  const int tj = valid ? (int)tjb[b] : 0;
  const int L = valid ? lens[b] : 0;
  int Lrun = L;  // the warp runs to its longest target
#pragma unroll
  for (int o = W; o < 32; o <<= 1)
    Lrun = max(Lrun, __shfl_xor_sync(FULL_MASK, Lrun, o));

  uint32_t m[R];
#pragma unroll
  for (int q = 0; q < R; ++q) m[q] = 0u;
  int xJ = 0;
  uint32_t xb2 = (uint32_t)min(max(max(190 - tj, 0) - tbm, 0), 32767) *
                 0x10001u;
  // xJ + tec in both halves: a row changes xJ iff some cell exceeds it
  uint32_t thr2 = (uint32_t)min(tec, 32767) * 0x10001u;

  auto load = [&](int x, uint32_t* w) {
    if (SPILL && x >= Ks) {  // (S = 128 only)
#pragma unroll
      for (int q = 0; q < R; ++q) w[q] = pair_word<S, SL>(g, x, q, hl);
    } else {
      const uint32_t* row = tab + x * (R * 32) + lane;
#pragma unroll
      for (int q = 0; q < R; ++q) w[q] = row[q * 32];
    }
  };

  const uint8_t* seq = codes + (size_t)(valid ? b : b0) * Lmax;
  uint32_t w[R];
  for (int i0 = 0; i0 < Lrun; i0 += W) {
    const int nr = min(W, Lrun - i0);
    // past its own length a target reads code 0 and stops voting
    const int mycode = i0 + hl < L ? (int)seq[i0 + hl] : 0;
    if constexpr (PREFETCH) load(__shfl_sync(FULL_MASK, mycode, 0, W), w);
    for (int r = 0; r < nr; ++r) {
      uint32_t wn[R];
      if constexpr (PREFETCH)
        load(__shfl_sync(FULL_MASK, mycode, (r + 1) % W, W), wn);
      else
        load(__shfl_sync(FULL_MASK, mycode, r, W), w);

      // the high half of the last word is slot SL-1 for every SL
      uint32_t up = __shfl_up_sync(FULL_MASK, m[R - 1], 1, W);
      if (hl == 0) up = 0u;  // slot 0 enters from B only (xBv >= 0)
      // pair 0: low half from the previous lane's slot SL-1, high half
      // from this lane's slot H-1
      const uint32_t edge = H ? __byte_perm(up, m[H > 0 ? H - 1 : 0], 0x5432)
                              : 0u;
      if constexpr (ODD)  // slot SL-1 takes slot SL-2, pair H-1's high half
        m[H] = __viaddmax_s16x2(__vimax_s16x2_relu(H ? m[H > 0 ? H - 1 : 0]
                                                     : up,
                                                   xb2),
                                w[H], 0u);
#pragma unroll
      for (int q = H - 1; q >= 1; --q)
        m[q] = __viaddmax_s16x2(__vimax_s16x2_relu(m[q - 1], xb2), w[q], 0u);
      if constexpr (H > 0)
        m[0] = __viaddmax_s16x2(__vimax_s16x2_relu(edge, xb2), w[0], 0u);
      const uint32_t mx2 = fold_max<R>(m);
      bool exceeds = __vimax_s16x2_relu(mx2, thr2) != thr2;
      if constexpr (G > 1) exceeds = exceeds && i0 + r < L;
      const unsigned vote = __ballot_sync(FULL_MASK, exceeds);
      if (vote) {
        const int lmax = max((int)(int16_t)(mx2 & 0xffffu),
                             (int)(int16_t)(mx2 >> 16));
        int gmax = 0;
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const int v = __reduce_max_sync(
              FULL_MASK, lane / W == k ? lmax : -32768);
          if (lane / W == k) gmax = v;
        }
        unsigned mine = vote;  // this target's lanes' votes
        if constexpr (G > 1)
          mine = (vote >> (lane / W * W)) & ((1u << W) - 1u);
        if (mine) {
          xJ = max(xJ, gmax - tec);
          const int xB = max(190, xJ) - tj;
          xb2 = (uint32_t)min(max(xB - tbm, 0), 32767) * 0x10001u;
          thr2 = (uint32_t)min(xJ + tec, 32767) * 0x10001u;
        }
      }
      if constexpr (PREFETCH) {
#pragma unroll
        for (int q = 0; q < R; ++q) w[q] = wn[q];
      }
    }
  }
  if (hl == 0 && valid) {
    const size_t o = (size_t)p * B + b;
    dx[o] = (float)(xJ - 190);
    ovf[o] = xJ >= 255 - bias - tec ? 1.f : 0.f;
  }
}

// The bias filter's 2-state scan: one thread per (profile, target) pair;
// a block is one target x BIAS_THREADS profiles, every thread reading the
// same code and its own profile's odds ([Kp][BIAS_THREADS] in shared
// memory).  The float operations are those of the fused scan, in order.
__global__ void __launch_bounds__(BIAS_THREADS)
bias_kernel(const uint8_t* __restrict__ codes, int Lmax,
            const int* __restrict__ lens,
            const float* __restrict__ odds,  // [P, Kp]
            const float* __restrict__ p1,    // [B]
            int B, int P, int Kp, float* __restrict__ biaslog) {
  __shared__ float od[32 * BIAS_THREADS];
  const int b = blockIdx.x;
  const int p0 = blockIdx.y * BIAS_THREADS;
  for (int t = threadIdx.x; t < 32 * BIAS_THREADS; t += BIAS_THREADS) {
    const int x = t / BIAS_THREADS, q = p0 + t % BIAS_THREADS;
    od[t] = (x < Kp && q < P) ? odds[q * Kp + x] : 0.f;
  }
  __syncthreads();
  const int p = p0 + threadIdx.x;
  if (p >= P) return;

  const int L = lens[b];
  const float t00 = p1[b], t01 = 1.f - t00;
  const float t11 = 50.f / 51.f, t10 = 1.f / 51.f;
  float a0 = 1.f, a1 = 0.f, lsc = 0.f;
  bool started = false;
  const uint8_t* seq = codes + (size_t)b * Lmax;
  for (int i0 = 0; i0 < L; i0 += 8) {
    // the 8 rows' odds first, off the recurrence's chain (0 past L: no
    // update, as at a nonresidue code)
    float ovs[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      ovs[k] = i0 + k < L
                   ? od[(int)seq[i0 + k] * BIAS_THREADS + threadIdx.x]
                   : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float ov = ovs[k];
      if (ov > 0.f) {
        float na0, na1;
        if (!started) {
          na0 = a0 * 0.999f;
          na1 = a0 * 0.001f * ov;
          started = true;
        } else {
          na0 = a0 * t00 + a1 * t10;
          na1 = (a0 * t01 + a1 * t11) * ov;
        }
        a0 = na0;
        a1 = na1;
      }
    }
    if (i0 + 8 <= L) {
      const float s = a0 + a1;
      lsc += logf(s);
      const float inv = 1.f / s;
      a0 *= inv;
      a1 *= inv;
    }
  }
  biaslog[(size_t)p * B + b] = lsc + logf(a0 + a1);
}

// The wide route's cells of one thread: R words in registers, or (R = 0)
// word q at col[q * MSV_CTA_THREADS] of the CTA's row in shared memory.
template <int R>
struct MsvCells {
  uint32_t c[R];
  __device__ __forceinline__ explicit MsvCells(uint32_t*) {}
  __device__ __forceinline__ uint32_t& at(int q) { return c[q]; }
};

template <>
struct MsvCells<0> {
  uint32_t* col;
  __device__ __forceinline__ explicit MsvCells(uint32_t* p) : col(p) {}
  __device__ __forceinline__ uint32_t& at(int q) {
    return col[q * MSV_CTA_THREADS];
  }
};

// One row of a thread's words (ascending q: word q takes word q-1's old
// value, word 0 the edge), each from its table word wq(q); returns the
// new last word, mx2 the thread's maximum of both halves.
template <int R, class Wq>
__device__ __forceinline__ uint32_t msv_cta_row(MsvCells<R>& m, int nr,
                                                uint32_t edge, uint32_t xb2,
                                                Wq wq, uint32_t& mx2) {
  uint32_t pm = edge, last = 0u;
  if constexpr (R > 0) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const uint32_t om = m.at(q);
      m.at(q) = __viaddmax_s16x2(__vimax_s16x2_relu(pm, xb2), wq(q), 0u);
      pm = om;
    }
    mx2 = fold_max<R>(m.c);
    last = m.at(R - 1);
  } else {
    uint32_t mx = 0u;
#pragma unroll 8
    for (int q = 0; q < nr; ++q) {
      const uint32_t om = m.at(q);
      last = __viaddmax_s16x2(__vimax_s16x2_relu(pm, xb2), wq(q), 0u);
      m.at(q) = last;
      mx = __vimax_s16x2_relu(mx, last);
      pm = om;
    }
    mx2 = mx;
  }
  return last;
}

// The wide route: pair w of a grid-strided loop is profile w / B, target
// w % B; MSV_CTA_THREADS threads, thread t owning nr words (R, or nr_
// for R = 0: the row in dynamic shared memory, [nr][MSV_CTA_THREADS],
// and for STAGED two table rows after it, [2][nr][NT], each thread
// copying its own words of the next row in with cp.async while it runs
// the current one).
template <int R, bool STAGED>
__global__ void __launch_bounds__(MSV_CTA_THREADS)
msv_cta_kernel(const uint8_t* __restrict__ codes, int Lmax,
               const int* __restrict__ lens,
               const uint32_t* __restrict__ w2,  // [P, Kp, nr, NT] s16x2
               const float* __restrict__ scal,   // [P, 4] bias, tec, tbm, -
               const float* __restrict__ tjb,    // [B]
               int B, int Kp, int nr_, int npairs, float* __restrict__ dx,
               float* __restrict__ ovf) {
  constexpr int NT = MSV_CTA_THREADS, NW = NT / 32;
  // lane 31's last word and a warp's row maximum when it voted, by row
  // parity
  __shared__ uint32_t sLast[2][NW];
  __shared__ int sMax[2][NW];
  extern __shared__ uint32_t srow[];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int nr = R ? R : nr_;
  MsvCells<R> m(srow + t);
  uint32_t* stg = srow + (size_t)nr * NT + t;  // this thread's staged words
  for (int w = blockIdx.x; w < npairs; w += gridDim.x) {
    const int p = w / B, b = w % B;
    __syncthreads();  // the previous pair's reads of sMax are done
    if (lane == 0) sMax[0][wid] = sMax[1][wid] = 0;
    const int bias = (int)scal[p * 4 + 0];
    const int tec = (int)scal[p * 4 + 1];
    const int tbm = (int)scal[p * 4 + 2];
    const int tj = (int)tjb[b];
    const int L = lens[b];
    const uint32_t* tab = w2 + (size_t)p * Kp * nr * NT + t;
    const uint8_t* seq = codes + (size_t)b * Lmax;
#pragma unroll
    for (int q = 0; q < nr; ++q) m.at(q) = 0u;
    int xJ = 0, par = 0;
    uint32_t xb2 = (uint32_t)min(max(max(190 - tj, 0) - tbm, 0), 32767) *
                   0x10001u;
    uint32_t thr2 = (uint32_t)min(tec, 32767) * 0x10001u;
    // the previous row's last word of the thread below (slot t*SPT - 1
    // in its high half); slot 0 enters from B only (xBv >= 0)
    uint32_t up = 0u;
    // this row's code and the next one's, loaded a row ahead, off the
    // row's dependency chain
    int xc = L > 0 ? (int)__ldg(seq) : 0;
    int xn = L > 1 ? (int)__ldg(seq + 1) : 0;

    // the row's end: a warp that has a lane over xJ + tec (xJ is
    // monotone, so only then can the row change it) reduces and
    // publishes its maximum; the row's one barrier tells every thread
    // whether any did and publishes the stripe edges
    auto end_row = [&](uint32_t last, uint32_t mx2) {
      const bool exceeds = __vimax_s16x2_relu(mx2, thr2) != thr2;
      if (__any_sync(FULL_MASK, exceeds)) {
        const int lmax = max((int)(int16_t)(mx2 & 0xffffu),
                             (int)(int16_t)(mx2 >> 16));
        const int wmax = __reduce_max_sync(FULL_MASK, lmax);
        if (lane == 0) sMax[par][wid] = wmax;
      }
      if (lane == 31) sLast[par][wid] = last;
      const uint32_t below = __shfl_up_sync(FULL_MASK, last, 1);
      const int fired = __syncthreads_or(exceeds);
      up = lane ? below : (wid ? sLast[par][wid - 1] : 0u);
      if (fired) {
        // a warp that did not vote holds 0 or an earlier row's maximum
        // of this pair, no more than xJ + tec
        int g = 0;
#pragma unroll
        for (int v = 0; v < NW; ++v) g = max(g, sMax[par][v]);
        xJ = max(xJ, g - tec);
        const int xB = max(190, xJ) - tj;
        xb2 = (uint32_t)min(max(xB - tbm, 0), 32767) * 0x10001u;
        thr2 = (uint32_t)min(xJ + tec, 32767) * 0x10001u;
      }
      par ^= 1;
    };

    if constexpr (R > 0) {
      // the table words a row ahead, in registers; two rows an iteration,
      // so the two word sets swap roles instead of being copied
      uint32_t wa[R], wb[R];
      auto load = [&](uint32_t (&wv)[R], int x) {
        const uint32_t* tw = tab + (size_t)x * R * NT;
#pragma unroll
        for (int q = 0; q < R; ++q) wv[q] = __ldg(tw + q * NT);
      };
      auto row = [&](int i, uint32_t (&cur)[R], uint32_t (&nxt)[R]) {
        const int xnn = i + 2 < L ? (int)__ldg(seq + i + 2) : 0;
        const uint32_t edge = __byte_perm(up, m.at(R - 1), 0x5432);
        load(nxt, xn);
        uint32_t mx2;
        const uint32_t last = msv_cta_row<R>(
            m, R, edge, xb2, [&](int q) { return cur[q]; }, mx2);
        xn = xnn;
        end_row(last, mx2);
      };
      load(wa, xc);
      for (int i = 0; i < L; i += 2) {
        row(i, wa, wb);
        if (i + 1 < L) row(i + 1, wb, wa);
      }
    } else {
      auto stage = [&](int buf, int x) {
        const uint32_t* tw = tab + (size_t)x * nr * NT;
        uint32_t* dst = stg + (size_t)buf * nr * NT;
        for (int q = 0; q < nr; ++q)
          __pipeline_memcpy_async(dst + q * NT, tw + q * NT, 4);
        __pipeline_commit();
      };
      if constexpr (STAGED) stage(0, xc);
      for (int i = 0; i < L; ++i) {
        const int xnn = i + 2 < L ? (int)__ldg(seq + i + 2) : 0;
        const uint32_t edge = __byte_perm(up, m.at(nr - 1), 0x5432);
        uint32_t mx2, last;
        if constexpr (STAGED) {
          __pipeline_wait_prior(0);  // this row's words have landed
          stage((i + 1) & 1, xn);    // the next row's, during this one
          const uint32_t* tw = stg + (size_t)(i & 1) * nr * NT;
          last = msv_cta_row<0>(m, nr, edge, xb2,
                                [&](int q) { return tw[q * NT]; }, mx2);
        } else {
          const uint32_t* tw = tab + (size_t)xc * nr * NT;
          last = msv_cta_row<0>(m, nr, edge, xb2,
                                [&](int q) { return __ldg(tw + q * NT); },
                                mx2);
        }
        xc = xn;
        xn = xnn;
        end_row(last, mx2);
      }
      // nothing left in flight into the next pair's buffers
      if constexpr (STAGED) __pipeline_wait_prior(0);
    }
    if (t == 0) {
      const size_t o = (size_t)p * B + b;
      dx[o] = (float)(xJ - 190);
      ovf[o] = xJ >= 255 - bias - tec ? 1.f : 0.f;
    }
  }
}

static int launch_bias(const void* codes, int Lmax, const void* lens,
                       const void* odds, const void* p1, int B, int P,
                       int Kp, void* biaslog, cudaStream_t st) {
  dim3 bgrid(B, (P + BIAS_THREADS - 1) / BIAS_THREADS);
  bias_kernel<<<bgrid, BIAS_THREADS, 0, st>>>(
      (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)odds,
      (const float*)p1, B, P, Kp, (float*)biaslog);
  return (int)cudaGetLastError();
}

template <int S>
static int launch_msv(const void* codes, int Lmax, const void* lens,
                      const void* w16, const void* scal, const void* tjb,
                      int B, int P, int Kp, void* dx, void* ovf,
                      cudaStream_t stream) {
  constexpr int SL = S * groups_for(S);
  constexpr int R = SL / 2 + (SL & 1);
  const int Ks = std::min(Kp, MSV_SMEM_MAX / (R * 32 * 4));
  if (Ks < Kp && S < 128) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Ks * R * 32 * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        msv_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int per_block = WARPS_PER_BLOCK * groups_for(S);
  dim3 grid((B + per_block - 1) / per_block, P);
  msv_kernel<S><<<grid, 32 * WARPS_PER_BLOCK, smem, stream>>>(
      (const uint8_t*)codes, Lmax, (const int*)lens, (const int16_t*)w16,
      (const float*)scal, (const float*)tjb, B, Kp, Ks, (float*)dx,
      (float*)ovf);
  return (int)cudaGetLastError();
}

extern "C" int msv_launch(const void* codes, int Lmax, const void* lens,
                          const void* w16, const void* scal,
                          const void* odds, const void* tjb, const void* p1,
                          int B, int P, int Kp, int S, void* dx, void* ovf,
                          void* biaslog, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (Kp > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int e = launch_bias(codes, Lmax, lens, odds, p1, B, P, Kp, biaslog,
                            st);
  if (e) return e;
  switch (S) {
#define PYHMMER_CASE(s)                                                    \
  case s:                                                                  \
    return launch_msv<s>(codes, Lmax, lens, w16, scal, tjb, B, P, Kp, dx, \
                         ovf, st);
    PYHMMER_STRIPES(PYHMMER_CASE)
#undef PYHMMER_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wide route: MSV_CTA_THREADS threads a pair, the row in
// registers for the word counts PYHMMER_MSV_CTA_REGS, else in shared
// memory (with the two staged table rows where the three fit); a grid of
// as many CTAs as the card holds at once.
template <class K>
static int msv_cta_go(K kernel, int smem, const void* codes, int Lmax,
                      const void* lens, const void* w16, const void* scal,
                      const void* tjb, int B, int Kp, int nr, int npairs,
                      void* dx, void* ovf, cudaStream_t st) {
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = resident_grid(kernel, MSV_CTA_THREADS, smem, npairs);
  kernel<<<grid, MSV_CTA_THREADS, smem, st>>>(
      (const uint8_t*)codes, Lmax, (const int*)lens, (const uint32_t*)w16,
      (const float*)scal, (const float*)tjb, B, Kp, nr, npairs, (float*)dx,
      (float*)ovf);
  return (int)cudaGetLastError();
}

extern "C" int msv_cta_launch(const void* codes, int Lmax, const void* lens,
                              const void* w16, const void* scal,
                              const void* odds, const void* tjb,
                              const void* p1, int B, int P, int Kp, int Mk,
                              void* dx, void* ovf, void* biaslog,
                              void* stream) {
  constexpr int NT = MSV_CTA_THREADS;
  if (B <= 0 || P <= 0) return 0;
  if (Kp > 32 || Mk <= 0 || Mk % CTA_THREADS || Mk % (2 * NT))
    return (int)cudaErrorInvalidValue;
  const long long npairs = (long long)P * B;
  if (npairs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int nr = Mk / (2 * NT);
  const int row = nr * NT * (int)sizeof(uint32_t);
  const int room = MSV_SMEM_MAX - MSV_CTA_SMEM_STATIC;
  if (row > room) return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  const int e = launch_bias(codes, Lmax, lens, odds, p1, B, P, Kp, biaslog,
                            st);
  if (e) return e;
  switch (nr) {
#define PYHMMER_CASE(r)                                                    \
  case r:                                                                  \
    return msv_cta_go(msv_cta_kernel<r, false>, 0, codes, Lmax, lens, w16, \
                      scal, tjb, B, Kp, nr, (int)npairs, dx, ovf, st);
    PYHMMER_MSV_CTA_REGS(PYHMMER_CASE)
#undef PYHMMER_CASE
    default:
      if (3 * row <= room)
        return msv_cta_go(msv_cta_kernel<0, true>, 3 * row, codes, Lmax,
                          lens, w16, scal, tjb, B, Kp, nr, (int)npairs, dx,
                          ovf, st);
      return msv_cta_go(msv_cta_kernel<0, false>, row, codes, Lmax, lens,
                        w16, scal, tjb, B, Kp, nr, (int)npairs, dx, ovf, st);
  }
}

extern "C" const char* pyhmmer_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
