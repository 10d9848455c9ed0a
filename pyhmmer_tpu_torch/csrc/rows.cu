// Survivor rows: the full-length Forward and Backward parsers of one
// (profile, target) pair and the posterior decode terms that the native
// domain definition (pyhmmer_tpu/csrc/hmmdp.cpp, hmmdp_domaindef with
// ext_rows) reads in place of running its own parsers.
//
// Replaces the TPU kernels pyhmmer_tpu/ops/rows_pallas.py:_fwd_rows_body
// and _bck_rows_body (both launched by _survivor_rows_impl).
//
// Semantics: HMMER's odds-space multihit local parsers in f32.  The
// forward kernel is fwd.cu's recurrence (every row rescaled by
// max(E, J, C, N), log scale accumulated) and also writes, for every row
// q = 0..L, the scaled specials B, E, J, C and the log scale rsf[q] as
// five planes [G, 5, Lmax + 1]; N is not stored, since
// fN[q] = exp(q log_loop - rsf[q]).  The backward kernel runs the reverse
// recurrence from row L (C = move, E = move/2) down to row 0, rescaling
// every row by max(M, J, C, N), and emits per row, divided by the
// Forward score exp(fsc):
//
//   term_b[q] = fB[q] bB[q] exp(rsf[q] + rsb[q] - fsc)            q = 0..L
//   term_e[q] = fE[q] bE[q] exp(rsf[q] + rsb[q] - fsc)            q = 1..L
//   term_w[q] = (fN[q-1] bN[q] + fJ[q-1] bJ[q] + fC[q-1] bC[q]) loop
//               exp(rsf[q-1] + rsb[q] - fsc)                       q = 1..L
//
// into terms [G, Lmax + 1, 3] (rows past L are left as the caller
// allocated them), plus the Backward score bsc = log bN[0] + rsb[0],
// which the caller holds against fsc.  Every exponent is summed before
// exp, so nothing leaves the f32 range on rows of up to a few thousand
// residues; a pair whose fsc is NEGMASS writes zero terms.
//
// Design: as fwd.cu -- one warp per pair, running to that pair's own
// length; lane l owns model slots l*S .. l*S+S-1 in registers; emission
// and transition odds are read by residue code from the striped tables of
// ops/batch.py.  The backward M->M, I->M and D->M terms into slot s come
// from slot s+1, so each lane multiplies its own slots' values by the
// forward tables' transitions at the same slot (tr 0-2 of slot s+1 are
// the transitions out of state s+1) and passes the products one slot
// down, across a lane edge with one __shfl_down_sync; no shifted tables
// are needed.  The reverse D chain nd[s] = v[s] + nd[s+1] tDD[s] is the
// affine-map warp scan of fwd.cu run the other way (__shfl_down_sync).
// The row-L initial chain needs no table either: it is the ordinary
// backward step from an all-zero state with C forced to move.  Padded
// slots take E like real ones but are cut off from them by the zero
// transitions of the tables.  Each lane stages one row of every 32 in
// registers and the warp stores 32 rows at once.  Bound: ALU and latency
// (a warp sum, a warp max and a 5-step scan per row), like fwd.cu.

#include "common.cuh"

// stripe widths the rows kernels are compiled for: Mk <= 768, the
// engine's eligibility limit (ops/rows_cuda.py:MAX_S must match)
#define PYHMMER_ROWS_STRIPES(X) X(1) X(2) X(3) X(4) X(6) X(8) X(12) X(16) X(24)

constexpr float TINY = 1e-30f;
enum { F_B, F_E, F_J, F_C, F_RS, NF };  // forward row planes
constexpr int NT = 3;                     // term_b, term_e, term_w

template <int S>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
fwd_rows_kernel(const uint8_t* __restrict__ codes, int Lmax,
                const int* __restrict__ lens, const float* __restrict__ lm,
                const float* __restrict__ ems,  // [P, Kp, S, 32] odds
                const float* __restrict__ eis,  // [P, Kp, S, 32] odds
                const float* __restrict__ tr,   // [P, 8, S, 32] odds
                const int* __restrict__ pair_p,
                const int* __restrict__ pair_row, int npairs, int Kp,
                float* __restrict__ frows,      // [G, NF, Lmax + 1]
                float* __restrict__ fsc) {      // [G]
  const int w = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (w >= npairs) return;
  const int lane = threadIdx.x & 31;
  const int p = pair_p[w], row = pair_row[w];
  const int L = lens[row];
  const float loop = lm[row * 4 + 0], move = lm[row * 4 + 1];
  const float log_move = lm[row * 4 + 3];
  const float* T = tr + (size_t)p * 8 * S * 32 + lane;
  const float* MS = ems + (size_t)p * Kp * S * 32 + lane;
  const float* IS = eis + (size_t)p * Kp * S * 32 + lane;
  const size_t Lp1 = (size_t)Lmax + 1;
  float* fr = frows + (size_t)w * NF * Lp1;
#define TR(t, j) __ldg(T + ((t) * S + (j)) * 32)

  // row 0: N = 1, B = move, E = J = C = 0, scale 0
  if (lane < NF) fr[lane * Lp1] = lane == F_B ? move : 0.f;

  float m[S], iv[S], d[S];
#pragma unroll
  for (int j = 0; j < S; ++j) m[j] = iv[j] = d[j] = 0.f;
  float xN = 1.f, xB = move, xJ = 0.f, xC = 0.f, lsc = 0.f;

  const uint8_t* seq = codes + (size_t)row * Lmax;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int nr = min(32, L - i0);
    const int mycode = lane < nr ? (int)seq[i0 + lane] : 0;
    // this lane's staged row i0 + lane + 1
    float sB = 0.f, sE = 0.f, sJ = 0.f, sC = 0.f, sR = 0.f;
    for (int r = 0; r < nr; ++r) {
      const int x = __shfl_sync(FULL_MASK, mycode, r);
      const float* ms = MS + x * S * 32;
      const float* is = IS + x * S * 32;
      float cm = __shfl_up_sync(FULL_MASK, m[S - 1], 1);
      float ci = __shfl_up_sync(FULL_MASK, iv[S - 1], 1);
      float cd = __shfl_up_sync(FULL_MASK, d[S - 1], 1);
      if (lane == 0) cm = ci = cd = 0.f;
#pragma unroll
      for (int j = S - 1; j >= 0; --j) {
        const float pm = j ? m[j - 1] : cm;
        const float pi = j ? iv[j - 1] : ci;
        const float pd = j ? d[j - 1] : cd;
        const float nm = __ldg(ms + j * 32) *
                         (pm * TR(0, j) + pi * TR(1, j) + pd * TR(2, j) +
                          xB * TR(3, j));
        const float ni = __ldg(is + j * 32) * (m[j] * TR(4, j) +
                                               iv[j] * TR(5, j));
        m[j] = nm;
        iv[j] = ni;
      }
      // D chain (fwd.cu): this stripe's map, a warp scan, the D row
      float A = 1.f, Bv = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        Bv = m[j] * TR(6, j) + Bv * TR(7, j);
        A *= TR(7, j);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float Ap = __shfl_up_sync(FULL_MASK, A, o);
        const float Bp = __shfl_up_sync(FULL_MASK, Bv, o);
        if (lane >= o) {
          Bv = Bp * A + Bv;
          A = Ap * A;
        }
      }
      float dd = __shfl_up_sync(FULL_MASK, Bv, 1);
      if (lane == 0) dd = 0.f;
      float es = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        d[j] = dd;
        es += m[j] + dd;
        dd = m[j] * TR(6, j) + dd * TR(7, j);
      }
      const float e = warp_sum_f(es);
      const float nj = xJ * loop + e * 0.5f;
      const float nc = xC * loop + e * 0.5f;
      const float nn = xN * loop;
      const float nb = (nn + nj) * move;
      const float mx = fmaxf(fmaxf(fmaxf(e, nj), fmaxf(nc, nn)), TINY);
      const float inv = 1.f / mx;
      lsc += logf(mx);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        m[j] *= inv;
        iv[j] *= inv;
        d[j] *= inv;
      }
      xJ = nj * inv;
      xC = nc * inv;
      xN = nn * inv;
      xB = nb * inv;
      if (lane == r) {
        sB = xB;
        sE = e * inv;
        sJ = xJ;
        sC = xC;
        sR = lsc;
      }
    }
    if (lane < nr) {
      const size_t q = (size_t)i0 + lane + 1;
      fr[F_B * Lp1 + q] = sB;
      fr[F_E * Lp1 + q] = sE;
      fr[F_J * Lp1 + q] = sJ;
      fr[F_C * Lp1 + q] = sC;
      fr[F_RS * Lp1 + q] = sR;
    }
  }
#undef TR
  if (lane == 0) fsc[w] = xC > 0.f ? logf(xC) + lsc + log_move : NEGMASS;
}

template <int S>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
bck_rows_kernel(const uint8_t* __restrict__ codes, int Lmax,
                const int* __restrict__ lens, const float* __restrict__ lm,
                const float* __restrict__ ems, const float* __restrict__ eis,
                const float* __restrict__ tr,
                const int* __restrict__ pair_p,
                const int* __restrict__ pair_row, int npairs, int Kp,
                const float* __restrict__ frows,  // [G, NF, Lmax + 1]
                const float* __restrict__ fsc,    // [G]
                float* __restrict__ terms,        // [G, Lmax + 1, NT]
                float* __restrict__ bsc) {        // [G]
  const int w = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (w >= npairs) return;
  const int lane = threadIdx.x & 31;
  const int p = pair_p[w], row = pair_row[w];
  const int L = lens[row];
  const float loop = lm[row * 4 + 0], move = lm[row * 4 + 1];
  const float log_loop = lm[row * 4 + 2];
  const float* T = tr + (size_t)p * 8 * S * 32 + lane;
  const float* MS = ems + (size_t)p * Kp * S * 32 + lane;
  const float* IS = eis + (size_t)p * Kp * S * 32 + lane;
  const size_t Lp1 = (size_t)Lmax + 1;
  const float* fr = frows + (size_t)w * NF * Lp1;
  float* tm = terms + (size_t)w * Lp1 * NT;
  const float fs = fsc[w];
  const bool live = fs > 0.5f * NEGMASS;
#define TR(t, j) __ldg(T + ((t) * S + (j)) * 32)

  float m[S], iv[S];  // backward M and I rows (M turns into M * emission)
#pragma unroll
  for (int j = 0; j < S; ++j) m[j] = iv[j] = 0.f;
  float xN = 0.f, xB = 0.f, xJ = 0.f, xC = 0.f, xE = 0.f, lsc = 0.f;

  const uint8_t* seq = codes + (size_t)row * Lmax;
  for (int r0 = L & ~31; r0 >= 0; r0 -= 32) {
    // this lane stages row q: its forward rows at q and q - 1, the
    // residue that leads from row q + 1 to row q, and its three terms
    const int q = r0 + lane;
    const bool mine = q <= L;
    float fB = 0.f, fE = 0.f, rs1 = 0.f, fJ0 = 0.f, fC0 = 0.f, rs0 = 0.f;
    if (mine) {
      fB = fr[F_B * Lp1 + q];
      fE = fr[F_E * Lp1 + q];
      rs1 = fr[F_RS * Lp1 + q];
      if (q > 0) {
        fJ0 = fr[F_J * Lp1 + q - 1];
        fC0 = fr[F_C * Lp1 + q - 1];
        rs0 = fr[F_RS * Lp1 + q - 1];
      }
    }
    const int mycode = q < L ? (int)seq[q] : 0;
    float tB = 0.f, tE = 0.f, tW = 0.f;
    for (int r = min(L, r0 + 31); r >= r0; --r) {
      // the state at row r from the state at row r + 1 (all zero at r = L)
      const int x = __shfl_sync(FULL_MASK, mycode, r - r0);
      const float* ms = MS + x * S * 32;
      const float* is = IS + x * S * 32;
      float bp = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        m[j] *= __ldg(ms + j * 32);
        bp += m[j] * TR(3, j);
      }
      const float B = warp_sum_f(bp);
      const float nj = xJ * loop + B * move;
      const float nn = xN * loop + B * move;
      const float nc = r == L ? move : xC * loop;
      const float ne = 0.5f * (nj + nc);
      // M->M, I->M and D->M terms of this lane's first slot, for the
      // previous lane's last slot
      float e0 = __shfl_down_sync(FULL_MASK, m[0] * TR(0, 0), 1);
      float e1 = __shfl_down_sync(FULL_MASK, m[0] * TR(1, 0), 1);
      float e2 = __shfl_down_sync(FULL_MASK, m[0] * TR(2, 0), 1);
      if (lane == 31) e0 = e1 = e2 = 0.f;
      // reverse D chain, pass 1: this stripe's map from nd at the next
      // stripe's first slot to nd at this stripe's first slot
      float A = 1.f, Bv = 0.f;
#pragma unroll
      for (int j = S - 1; j >= 0; --j) {
        const float s2 = j == S - 1 ? e2 : m[j + 1] * TR(2, j + 1);
        Bv = (ne + s2) + Bv * TR(7, j);
        A *= TR(7, j);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float An = __shfl_down_sync(FULL_MASK, A, o);
        const float Bn = __shfl_down_sync(FULL_MASK, Bv, o);
        if (lane + o < 32) {
          Bv = A * Bn + Bv;
          A = A * An;
        }
      }
      float dd = __shfl_down_sync(FULL_MASK, Bv, 1);
      if (lane == 31) dd = 0.f;
      // pass 2: the M and I rows, walking down from the stripe's last
      // slot with dd = nd[s + 1] and un = this lane's M * emission at s + 1
      float mx = 0.f, un = 0.f;
#pragma unroll
      for (int j = S - 1; j >= 0; --j) {
        float s0, s1, s2;
        if (j == S - 1) {
          s0 = e0;
          s1 = e1;
          s2 = e2;
        } else {
          s0 = un * TR(0, j + 1);
          s1 = un * TR(1, j + 1);
          s2 = un * TR(2, j + 1);
        }
        const float isv = __ldg(is + j * 32);
        const float nm = ne + s0 + iv[j] * TR(4, j) * isv + dd * TR(6, j);
        const float ni = s1 + iv[j] * TR(5, j) * isv;
        dd = (ne + s2) + dd * TR(7, j);
        un = m[j];
        m[j] = nm;
        iv[j] = ni;
        mx = fmaxf(mx, nm);
      }
      mx = fmaxf(fmaxf(warp_max_f(mx), fmaxf(nj, nc)), fmaxf(nn, TINY));
      const float inv = 1.f / mx;
      lsc += logf(mx);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        m[j] *= inv;
        iv[j] *= inv;
      }
      xJ = nj * inv;
      xC = nc * inv;
      xN = nn * inv;
      xB = B * inv;
      xE = ne * inv;
      if (lane == r - r0) {
        const float ex1 = expf(rs1 + lsc - fs);
        tB = fB * xB * ex1;
        if (r > 0) {
          tE = fE * xE * ex1;
          const float ex0 = expf(rs0 + lsc - fs);
          const float en = expf((float)(r - 1) * log_loop + lsc - fs);
          tW = (en * xN + (fJ0 * xJ + fC0 * xC) * ex0) * loop;
        }
      }
    }
    if (mine) {
      float* t = tm + (size_t)q * NT;
      t[0] = live ? tB : 0.f;
      t[1] = live ? tE : 0.f;
      t[2] = live ? tW : 0.f;
    }
  }
#undef TR
  if (lane == 0) bsc[w] = xN > 0.f ? logf(xN) + lsc : NEGMASS;
}

template <int S>
static int launch_rows(const void* codes, int Lmax, const void* lens,
                       const void* lm, const void* ems, const void* eis,
                       const void* tr, const void* pair_p,
                       const void* pair_row, int npairs, int Kp,
                       void* frows, void* fsc, void* terms, void* bsc,
                       cudaStream_t stream) {
  const int grid = (npairs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  fwd_rows_kernel<S><<<grid, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)lm,
      (const float*)ems, (const float*)eis, (const float*)tr,
      (const int*)pair_p, (const int*)pair_row, npairs, Kp, (float*)frows,
      (float*)fsc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bck_rows_kernel<S><<<grid, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)lm,
      (const float*)ems, (const float*)eis, (const float*)tr,
      (const int*)pair_p, (const int*)pair_row, npairs, Kp,
      (const float*)frows, (const float*)fsc, (float*)terms, (float*)bsc);
  return (int)cudaGetLastError();
}

extern "C" int rows_launch(const void* codes, int Lmax, const void* lens,
                           const void* lm, const void* ems, const void* eis,
                           const void* tr, const void* pair_p,
                           const void* pair_row, int npairs, int Kp, int S,
                           void* frows, void* fsc, void* terms, void* bsc,
                           void* stream) {
  if (npairs <= 0) return 0;
  switch (S) {
#define PYHMMER_CASE(s)                                                    \
  case s:                                                                  \
    return launch_rows<s>(codes, Lmax, lens, lm, ems, eis, tr, pair_p,     \
                          pair_row, npairs, Kp, frows, fsc, terms, bsc,    \
                          (cudaStream_t)stream);
    PYHMMER_ROWS_STRIPES(PYHMMER_CASE)
#undef PYHMMER_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
