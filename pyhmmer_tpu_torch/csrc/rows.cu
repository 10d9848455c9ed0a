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
// recurrence from row L (C = move, E = move/2) down to row 0 and emits
// per row, divided by the Forward score exp(fsc):
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
// residues; a pair whose fsc is NEGMASS writes zero terms.  Each row is
// scaled by a power of two, 2^-floor(log2 max): the product is exact and
// the scale's log an integer, summed exactly and taken times log 2 where
// rsf, rsb and the scores need it.  Since the scale is the factor
// actually applied, the terms do not depend on which one was chosen (the
// kernels' differ from the plain version's; below).
//
// Tables: the Forward filter kernel's packed odds (ops/batch.py:
// fwd_emis, fwd_trans; S <= 24 slots a lane, so the narrow layout): a
// slot's (M, I) emission odds of a residue in one float2 load and its
// eight transitions in two float4 loads, each contiguous over the warp;
// up to 8 slots a thread the transitions stay in registers and the next
// row's emissions load during this row.  The backward M->M, I->M and
// D->M terms into slot s come from slot s+1's own transitions (slot s+1
// owns the transitions into it), so no shifted table is needed.
//
// Bound on this card: the latency of each row's dependency chain.  A
// launch holds 10 to 256 pairs (PERF.md: the main path's hold 15-30), so
// most SMs run one warp or none and the time is the longest pair's rows
// times the chain of one row.  The first version of these kernels issued
// ten loads a slot and row and, per row, a 5-step scan with two shuffles
// a step, a separate 5-shuffle E sum, the stripe's D chain twice, a warp
// max after the backward's M row, and the decode's three exp in one lane
// while the others waited: about 1,100 cycles a row at 3 slots a lane.
// The design against that:
//
// * Forward: fwd.cu's single warp scan, which carries the D chain and E
//   together, with the row-invariant multipliers computed once per pair
//   in double.
// * The power-of-two scale takes two integer operations from the row's
//   max, where a reciprocal and a log took a MUFU round trip each.
// * Backward: the reverse D chain nd[s] = ne + s2[s] + nd[s+1] tDD[s] is
//   affine in the row's E: nd[s] = ne Wr[s] + Q[s], Wr row-invariant
//   (Wr[s] = 1 + tDD[s] Wr[s+1]) and Q the chain of the s2 terms alone
//   (s2[s] = the D->M term into slot s+1).  So the scan of Q runs beside
//   B's warp sum instead of after it; once E is known, each thread's D
//   enters from above as ne Wr + Q and walks down its own slots.  The
//   row is rescaled by the largest value of the row before it (one row
//   late: the values of a row then exceed 1 by at most that row's growth,
//   far inside f32's range), so the warp max runs beside the next row's
//   sums instead of on the chain.  Chain a row: [B sum | Q scan] -> E ->
//   the thread's D walk -> the M row.
// * The decode terms of 32 rows are staged one row a lane and computed
//   by all lanes at once (three exp each) after the 32 rows.
// * The block route (vit.cu's): NW warps a pair, SP = S / NW slots a
//   thread, stripe position j of lane l held by warp j / SP; the slots
//   run lane-major, so thread (w, l) follows (w - 1, l) and (0, l)
//   follows (NW - 1, l - 1).  Once a row each thread writes its map (and
//   its carries) to shared memory, one barrier, and every thread composes
//   its lane's column of NW maps; the lane scan is then a warp's as
//   above.  Buffers alternate by row, so one barrier a row is enough: the
//   forward's E, the backward's B sum, Q map and (one row late) max all
//   join there.  It spreads a wide model's slots over more of the SM,
//   from 12 slots a lane; where a launch has more pairs than the card
//   holds at once, one warp a pair issues less and is the default.
//
// Padded slots take E like real ones but are cut off from them by the
// zero transitions of the tables.

#include "common.cuh"

// stripe widths the rows kernels are compiled for: Mk <= 768, the
// engine's eligibility limit (ops/rows_cuda.py:MAX_S must match)
#define PYHMMER_ROWS_STRIPES(X) X(1) X(2) X(3) X(4) X(6) X(8) X(12) X(16) X(24)

constexpr float TINY = 1e-30f;
constexpr float LN2 = 0.69314718055994530942f;
enum { F_B, F_E, F_J, F_C, F_RS, NF };  // forward row planes
constexpr int NT = 3;                     // term_b, term_e, term_w
// warps a pair on the block route, 4 slots a thread; it exists from 12
// slots a lane (at 6 and 8 one warp a pair was 4-12% faster on every
// launch of the smoke search and the forced cascade; PERF.md)
constexpr int rows_warps(int S) { return S < 12 ? 1 : S / 4; }

// One thread's view of a profile's packed odds tables, for its SP slots
// from stripe position j0 of its lane: transitions ta(jj) = (tMM, tIM,
// tDM, tBM) and tb(jj) = (tMI, tII, tMD, tDD), the (M, I) emission odds
// of residue x em(x, jj).
// The scale of a row whose largest value is mx (TINY <= mx < 2^100):
// 2^-e for e = floor(log2 mx), exact; adds e to the row's log2 scale.
__device__ __forceinline__ float pow2_scale(float mx, int& log2_scale) {
  const int e = (__float_as_int(mx) >> 23) - 127;
  log2_scale += e;
  return __int_as_float((127 - e) << 23);
}

template <int S, int SP>
struct Slots {
  static constexpr bool TR_REGS = SP <= 8;
  const float4* tr;
  const float2* em_;
  float4 ra[TR_REGS ? SP : 1], rb[TR_REGS ? SP : 1];
  __device__ Slots(const float2* emis, const float4* trans, int p, int Kp,
                   int lane, int j0)
      : tr(trans + ((size_t)p * S + j0) * 64 + lane),
        em_(emis + ((size_t)p * Kp * S + j0) * 32 + lane) {
    if constexpr (TR_REGS) {
#pragma unroll
      for (int jj = 0; jj < SP; ++jj) {
        ra[jj] = __ldg(tr + 64 * jj);
        rb[jj] = __ldg(tr + 64 * jj + 32);
      }
    }
  }
  __device__ float4 ta(int jj) const {
    if constexpr (TR_REGS) return ra[jj];
    else return __ldg(tr + 64 * jj);
  }
  __device__ float4 tb(int jj) const {
    if constexpr (TR_REGS) return rb[jj];
    else return __ldg(tr + 64 * jj + 32);
  }
  __device__ void load(int x, float2* e) const {
    const float2* ex = em_ + (size_t)x * S * 32;
#pragma unroll
    for (int jj = 0; jj < SP; ++jj) e[jj] = __ldg(ex + 32 * jj);
  }
};

// The pair of this thread: one warp a pair (NW = 1, several pairs a
// block) or one block a pair.  False for a warp past the last pair.
template <int NW>
__device__ __forceinline__ bool rows_pair(int npairs, int& w, int& wi) {
  if constexpr (NW == 1) {
    w = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    wi = 0;
    return w < npairs;
  } else {
    w = blockIdx.x;
    wi = threadIdx.x >> 5;
    return true;
  }
}

// (a minimum of one block a SM: without it ptxas keeps 64-80 registers
// at 1-2 slots a lane and spills)
template <int S, int NW>
__global__ void __launch_bounds__(32 * (NW == 1 ? WARPS_PER_BLOCK : NW), 1)
fwd_rows_kernel(const uint8_t* __restrict__ codes, int Lmax,
                const int* __restrict__ lens, const float* __restrict__ lm,
                const float2* __restrict__ emis,   // [P, Kp, S, 32] (M, I)
                const float4* __restrict__ trans,  // [P, S, 2, 32] 8 a slot
                const int* __restrict__ pair_p,
                const int* __restrict__ pair_row, int npairs, int Kp,
                float* __restrict__ frows,         // [G, NF, Lmax + 1]
                float* __restrict__ fsc) {         // [G]
  constexpr int SP = S / NW;            // slots a thread
  constexpr bool PREFETCH = SP <= 8;    // next row's emissions ahead
  constexpr int NACC = SP >= 8 ? 4 : 1;  // partial sums of E
  constexpr int NWS = NW == 1 ? 1 : NW;
  const int lane = threadIdx.x & 31;
  int w, wi;
  if (!rows_pair<NW>(npairs, w, wi)) return;
  const int p = pair_p[w], row = pair_row[w];
  const int L = lens[row];
  const float loop = lm[row * 4 + 0], move = lm[row * 4 + 1];
  const float log_move = lm[row * 4 + 3];
  const Slots<S, SP> sl(emis, trans, p, Kp, lane, wi * SP);
  const size_t Lp1 = (size_t)Lmax + 1;
  float* fr = frows + (size_t)w * NF * Lp1;

  // the row-invariant D->D terms of this thread's slots (in double,
  // rounded once): pre[jj], the product of tDD before slot jj; their
  // product A, their sum W and the last one, alpha
  float pre[SP];
  double Ad = 1.0, Wd = 0.0;
#pragma unroll
  for (int jj = 0; jj < SP; ++jj) {
    pre[jj] = (float)Ad;
    Wd += Ad;
    Ad *= sl.tb(jj).w;
  }
  const float alpha = pre[SP - 1];

  // the block route: per thread its (A, W, alpha); by row parity its
  // map (B, C) and its last slot (m, i, local d)
  __shared__ float4 sAW[NWS][32];
  __shared__ float2 sBC[2][NWS][32];
  __shared__ float4 sCar[2][NWS][32];
  // products of A below this thread, below the thread under it and
  // below the last warp of the lane under this one; alpha of the thread
  // under this one; the lane's column of (A, W), held in registers
  float Aown = 1.f, Apred = 1.f, Aq_left = 1.f, alpha_pred = 0.f;
  float Acol[NWS], Wcol[NWS];
  if constexpr (NW > 1) {
    sAW[wi][lane] = make_float4((float)Ad, (float)Wd, alpha, 0.f);
    __syncthreads();
    double Ar = 1.0, Wr = 0.0;
    float Aq = 1.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      if (v == wi - 1) Apred = (float)Ar;
      if (v == wi) Aown = (float)Ar;
      if (v == NW - 1) Aq = (float)Ar;
      const float4 aw = sAW[v][lane];
      Acol[v] = aw.x;
      Wcol[v] = aw.y;
      Wr += Ar * aw.y;
      Ar *= aw.x;
    }
    Ad = Ar;
    Wd = Wr;
    Aq_left = __shfl_up_sync(FULL_MASK, Aq, 1);
    const float alpha_left =
        __shfl_up_sync(FULL_MASK, sAW[NW - 1][lane].z, 1);
    alpha_pred = wi > 0 ? sAW[wi - 1][lane].z : alpha_left;
  }
  // the lane scan's multipliers, from the lane's (A, W); 0 where there is
  // no window below
  float amul[5], wmul[5], cmul[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double Ap = __shfl_up_sync(FULL_MASK, Ad, 1 << k);
    const double Wp = __shfl_up_sync(FULL_MASK, Wd, 1 << k);
    const bool has = lane >= (1 << k);
    amul[k] = has ? (float)Ad : 0.f;
    wmul[k] = has ? (float)Wd : 0.f;
    cmul[k] = has ? 1.f : 0.f;
    if (has) {
      Wd = Wd * Ap + Wp;
      Ad *= Ap;
    }
  }

  // row 0: N = 1, B = move, E = J = C = 0, scale 0
  if (wi == 0 && lane < NF) fr[lane * Lp1] = lane == F_B ? move : 0.f;

  float m[SP], iv[SP], d[SP];
#pragma unroll
  for (int jj = 0; jj < SP; ++jj) m[jj] = iv[jj] = d[jj] = 0.f;
  float xN = 1.f, xB = move, xJ = 0.f, xC = 0.f;
  int ls2 = 0;                         // the log2 scale so far
  float cm = 0.f, ci = 0.f, cd = 0.f;  // block route: the slot below
  int par = 0;

  const uint8_t* seq = codes + (size_t)row * Lmax;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int nr = min(32, L - i0);
    const int mycode = lane < nr ? (int)seq[i0 + lane] : 0;
    float2 ec[SP];
    if constexpr (PREFETCH) sl.load(__shfl_sync(FULL_MASK, mycode, 0), ec);
    // this lane's staged row i0 + lane + 1
    float sB = 0.f, sE = 0.f, sJ = 0.f, sC = 0.f, sR = 0.f;
    for (int r = 0; r < nr; ++r) {
      // the next row's emissions, off this row's dependency chain (the
      // last row of a block loads one it does not use)
      float2 en[PREFETCH ? SP : 1];
      if constexpr (PREFETCH)
        sl.load(__shfl_sync(FULL_MASK, mycode, (r + 1) & 31), en);
      else
        sl.load(__shfl_sync(FULL_MASK, mycode, r), ec);
      // the previous row's slot below this thread's first
      float pm, pi, pd;
      if constexpr (NW == 1) {
        pm = __shfl_up_sync(FULL_MASK, m[SP - 1], 1);
        pi = __shfl_up_sync(FULL_MASK, iv[SP - 1], 1);
        pd = __shfl_up_sync(FULL_MASK, d[SP - 1], 1);
        if (lane == 0) pm = pi = pd = 0.f;
      } else {
        pm = cm;
        pi = ci;
        pd = cd;
      }
      // M and I from the previous row; D with 0 entering the thread
      float dl = 0.f, es[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) es[k] = 0.f;
#pragma unroll
      for (int jj = 0; jj < SP; ++jj) {
        const float4 a = sl.ta(jj), b = sl.tb(jj);
        const float2 e = ec[jj];
        const float om = m[jj], oi = iv[jj], od = d[jj];
        const float nm = e.x * (pm * a.x + pi * a.y + pd * a.z + xB * a.w);
        m[jj] = nm;
        iv[jj] = e.y * (om * b.x + oi * b.y);
        d[jj] = dl;
        es[jj % NACC] += nm + dl;
        dl = dl * b.w + nm * b.z;
        pm = om;
        pi = oi;
        pd = od;
      }
      float C = es[0];
#pragma unroll
      for (int k = 1; k < NACC; ++k) C += es[k];
      // the thread's map x -> (x A + B, x W + C) of the D value x
      // entering it; on the block route composed over the lane's column
      float B = dl;
      float Bown = 0.f, Bpred = 0.f, Bq = 0.f;
      float4 car = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (NW > 1) {
        sBC[par][wi][lane] = make_float2(B, C);
        sCar[par][wi][lane] = make_float4(m[SP - 1], iv[SP - 1], d[SP - 1],
                                          0.f);
        __syncthreads();
        float Br = 0.f, Cr = 0.f;
#pragma unroll
        for (int v = 0; v < NW; ++v) {
          if (v == wi - 1) Bpred = Br;
          if (v == wi) Bown = Br;
          if (v == NW - 1) Bq = Br;
          const float2 bc = sBC[par][v][lane];
          Cr = fmaf(Br, Wcol[v], Cr) + bc.y;
          Br = fmaf(Br, Acol[v], bc.x);
        }
        B = Br;
        C = Cr;
        car = sCar[par][wi > 0 ? wi - 1 : NW - 1]
                  [wi > 0 ? lane : max(lane - 1, 0)];
        par ^= 1;
      }
      // the lanes' maps, scanned: B and C in parallel each step
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float Bp = __shfl_up_sync(FULL_MASK, B, 1 << k);
        const float Cp = __shfl_up_sync(FULL_MASK, C, 1 << k);
        C = fmaf(cmul[k], Cp, fmaf(wmul[k], Bp, C));
        B = fmaf(amul[k], Bp, B);
      }
      float X = __shfl_up_sync(FULL_MASK, B, 1);  // D entering the lane
      if (lane == 0) X = 0.f;
      const float e = __shfl_sync(FULL_MASK, C, 31);  // E of the row
      const float dd = NW > 1 ? fmaf(X, Aown, Bown) : X;  // D entering
      const float nj = xJ * loop + e * 0.5f;
      const float nc = xC * loop + e * 0.5f;
      const float nn = xN * loop;
      const float nb = (nn + nj) * move;
      const float inv = pow2_scale(
          fmaxf(fmaxf(fmaxf(e, nj), fmaxf(nc, nn)), TINY), ls2);
      // the D row (what enters the thread added back), then the rescale
#pragma unroll
      for (int jj = 0; jj < SP; ++jj) {
        m[jj] *= inv;
        iv[jj] *= inv;
        d[jj] = fmaf(dd, pre[jj], d[jj]) * inv;
      }
      if constexpr (NW > 1) {
        // the next row's carry: the last slot of the thread below, whose
        // D is its local one plus what entered it times alpha
        float xp;
        if (wi > 0) {
          xp = fmaf(X, Apred, Bpred);
        } else {
          const float Xl = __shfl_up_sync(FULL_MASK, X, 1);
          const float Bql = __shfl_up_sync(FULL_MASK, Bq, 1);
          xp = fmaf(Xl, Aq_left, Bql);
        }
        const bool first = wi == 0 && lane == 0;
        cm = first ? 0.f : car.x * inv;
        ci = first ? 0.f : car.y * inv;
        cd = first ? 0.f : fmaf(xp, alpha_pred, car.z) * inv;
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
        sR = (float)ls2 * LN2;
      }
      if constexpr (PREFETCH) {
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) ec[jj] = en[jj];
      }
    }
    if (wi == 0 && lane < nr) {
      const size_t q = (size_t)i0 + lane + 1;
      fr[F_B * Lp1 + q] = sB;
      fr[F_E * Lp1 + q] = sE;
      fr[F_J * Lp1 + q] = sJ;
      fr[F_C * Lp1 + q] = sC;
      fr[F_RS * Lp1 + q] = sR;
    }
  }
  if (threadIdx.x % (32 * NWS) == 0)
    fsc[w] = xC > 0.f ? logf(xC) + (float)ls2 * LN2 + log_move : NEGMASS;
}

template <int S, int NW>
__global__ void __launch_bounds__(32 * (NW == 1 ? WARPS_PER_BLOCK : NW), 1)
bck_rows_kernel(const uint8_t* __restrict__ codes, int Lmax,
                const int* __restrict__ lens, const float* __restrict__ lm,
                const float2* __restrict__ emis,
                const float4* __restrict__ trans,
                const int* __restrict__ pair_p,
                const int* __restrict__ pair_row, int npairs, int Kp,
                const float* __restrict__ frows,  // [G, NF, Lmax + 1]
                const float* __restrict__ fsc,    // [G]
                float* __restrict__ terms,        // [G, Lmax + 1, NT]
                float* __restrict__ bsc) {        // [G]
  constexpr int SP = S / NW;
  constexpr bool PREFETCH = SP <= 8;
  constexpr int NWS = NW == 1 ? 1 : NW;
  const int lane = threadIdx.x & 31;
  int w, wi;
  if (!rows_pair<NW>(npairs, w, wi)) return;
  const int p = pair_p[w], row = pair_row[w];
  const int L = lens[row];
  const float loop = lm[row * 4 + 0], move = lm[row * 4 + 1];
  const float log_loop = lm[row * 4 + 2];
  const Slots<S, SP> sl(emis, trans, p, Kp, lane, wi * SP);
  const size_t Lp1 = (size_t)Lmax + 1;
  const float* fr = frows + (size_t)w * NF * Lp1;
  float* tm = terms + (size_t)w * Lp1 * NT;
  const float fs = fsc[w];
  const bool live = fs > 0.5f * NEGMASS;

  // the row-invariant terms of this thread's slots (in double, rounded
  // once), walking down from its last slot: A, the product of their tDD;
  // Pl, the same without the last slot's; wl, Wr at the first slot with
  // 0 entering from above
  double Ad = 1.0, Pd = 1.0, wd = 0.0;
#pragma unroll
  for (int jj = SP - 1; jj >= 0; --jj) {
    const double t7 = sl.tb(jj).w;
    wd = 1.0 + t7 * wd;
    Ad *= t7;
    if (jj < SP - 1) Pd *= t7;
  }
  const float Pl = (float)Pd;

  // the block route: per thread (A, Pl, wl); by row parity the products
  // of its first slot's me with tMM, tIM, tDM and its B share, and its Q
  // map with 0 entering and its share of the previous row's max
  __shared__ float4 sAP[NWS][32];
  __shared__ float4 sEdge[2][NWS][32];
  __shared__ float2 sQ[2][NWS][32];
  // the map from what enters the lane to the first slot of the thread
  // above this one: A_suf (row-invariant) and, per row, c_suf
  float A_suf = 1.f, w_suf = 0.f;
  float Acol[NWS], Pcol[NWS];  // the lane's column of (A, Pl)
  if constexpr (NW > 1) {
    sAP[wi][lane] = make_float4((float)Ad, Pl, (float)wd, 0.f);
    __syncthreads();
    double Ar = 1.0, wr = 0.0;
#pragma unroll
    for (int v = NW - 1; v >= 0; --v) {
      if (v == wi) {
        A_suf = (float)Ar;
        w_suf = (float)wr;
      }
      const float4 ap = sAP[v][lane];
      Acol[v] = ap.x;
      Pcol[v] = ap.y;
      wr = wr * ap.x + ap.z;
      Ar *= ap.x;
    }
    Ad = Ar;
    wd = wr;
  }
  // the lane scan from lane 31 down: its multipliers from the lane's A,
  // and Wr entering the lane from above (row-invariant)
  float amul[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double An = __shfl_down_sync(FULL_MASK, Ad, 1 << k);
    const double wn = __shfl_down_sync(FULL_MASK, wd, 1 << k);
    const bool has = lane + (1 << k) < 32;
    amul[k] = has ? (float)Ad : 0.f;
    if (has) {
      wd = wn * Ad + wd;
      Ad *= An;
    }
  }
  float Wr_in = (float)__shfl_down_sync(FULL_MASK, wd, 1);
  if (lane == 31) Wr_in = 0.f;
  // Wr at the first slot of the thread above this one
  const float Wr_n = fmaf(A_suf, Wr_in, w_suf);

  float m[SP], iv[SP];  // backward M and I rows
#pragma unroll
  for (int jj = 0; jj < SP; ++jj) m[jj] = iv[jj] = 0.f;
  float xN = 0.f, xB = 0.f, xJ = 0.f, xC = 0.f, xE = 0.f;
  int ls2 = 0;  // the log2 scale so far
  // this thread's largest value of the previous row (1 before row L)
  float mprev = 1.f;
  int par = 0;

  const uint8_t* seq = codes + (size_t)row * Lmax;
  for (int r0 = L & ~31; r0 >= 0; r0 -= 32) {
    // this lane stages row q: its forward rows at q and q - 1, the
    // residue that leads from row q + 1 to row q, and its backward
    // specials and scale
    const int q = r0 + lane;
    const bool mine = wi == 0 && q <= L;
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
    const int rtop = min(L, r0 + 31);
    float2 ec[SP];
    if constexpr (PREFETCH)
      sl.load(__shfl_sync(FULL_MASK, mycode, rtop - r0), ec);
    float sB = 0.f, sE = 0.f, sN = 0.f, sJ = 0.f, sC = 0.f, sR = 0.f;
    for (int r = rtop; r >= r0; --r) {
      // the state at row r from the state at row r + 1 (all zero at r = L)
      float2 en[PREFETCH ? SP : 1];
      if constexpr (PREFETCH)
        sl.load(__shfl_sync(FULL_MASK, mycode, (r - 1 - r0) & 31), en);
      else
        sl.load(__shfl_sync(FULL_MASK, mycode, r - r0), ec);
      // M turns into M * emission (me), I into I * emission; the B share;
      // the products of the first slot's me with the transitions into it
      float bp = 0.f;
#pragma unroll
      for (int jj = 0; jj < SP; ++jj) {
        m[jj] *= ec[jj].x;
        iv[jj] *= ec[jj].y;
        bp = fmaf(m[jj], sl.ta(jj).w, bp);
      }
      const float4 a0 = sl.ta(0);
      const float f0 = m[0] * a0.x, f1 = m[0] * a0.y, f2 = m[0] * a0.z;
      // Q from this thread's last slot down to its first, with 0 at the
      // last slot: the thread's map is Qn -> (f2' + tDD Qn) Pl + q, where
      // Qn is Q at the first slot of the thread above and f2' that
      // slot's D->M product
      float qc = 0.f;
#pragma unroll
      for (int jj = SP - 2; jj >= 0; --jj)
        qc = fmaf(qc, sl.tb(jj).w, m[jj + 1] * sl.ta(jj + 1).z);
      // the thread above's first-slot products (g), the row's B sum, the
      // previous row's max and Q entering this thread (Qn)
      float g0, g1, g2, Qn;
      float c;  // the lane's map constant
      float c_suf = 0.f;
      if constexpr (NW == 1) {
        g0 = __shfl_down_sync(FULL_MASK, f0, 1);
        g1 = __shfl_down_sync(FULL_MASK, f1, 1);
        g2 = __shfl_down_sync(FULL_MASK, f2, 1);
        if (lane == 31) g0 = g1 = g2 = 0.f;
        c = fmaf(g2, Pl, qc);
      } else {
        sEdge[par][wi][lane] = make_float4(f0, f1, f2, bp);
        sQ[par][wi][lane] = make_float2(qc, mprev);
        __syncthreads();
        // lane + 1's first thread, above this lane's last (none above
        // lane 31)
        float4 up = sEdge[par][0][min(lane + 1, 31)];
        if (lane == 31) up = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 g = up, ea = up;  // the thread above this one; above v
        float cr = 0.f, bs = 0.f, mx = 0.f;
#pragma unroll
        for (int v = NW - 1; v >= 0; --v) {
          if (v == wi) {
            c_suf = cr;
            g = ea;
          }
          const float4 ev = sEdge[par][v][lane];
          const float2 qv = sQ[par][v][lane];
          cr = fmaf(cr, Acol[v], fmaf(ea.z, Pcol[v], qv.x));
          bs += ev.w;
          mx = fmaxf(mx, qv.y);
          ea = ev;
        }
        c = cr;
        bp = bs;
        mprev = mx;
        g0 = g.x;
        g1 = g.y;
        g2 = g.z;
        par ^= 1;
      }
      // B (butterfly sum), the previous row's max (butterfly max) and the
      // lanes' Q maps (scan from lane 31 down), side by side
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        bp += __shfl_xor_sync(FULL_MASK, bp, 16 >> k);
        mprev = fmaxf(mprev, __shfl_xor_sync(FULL_MASK, mprev, 16 >> k));
        c = fmaf(amul[k], __shfl_down_sync(FULL_MASK, c, 1 << k), c);
      }
      float Qin = __shfl_down_sync(FULL_MASK, c, 1);  // Q entering the lane
      if (lane == 31) Qin = 0.f;
      Qn = NW > 1 ? fmaf(A_suf, Qin, c_suf) : Qin;
      const float inv = pow2_scale(fmaxf(mprev, TINY), ls2);
      const float B = bp;
      const float nj = xJ * loop + B * move;
      const float nn = xN * loop + B * move;
      const float nc = r == L ? move : xC * loop;
      const float ne = 0.5f * (nj + nc);
      // D at the first slot of the thread above, then down this thread's
      // slots with s = the products of the slot above's me
      float dn = fmaf(ne, Wr_n, Qn);
      float s0 = g0, s1 = g1, s2 = g2, ml = 0.f;
#pragma unroll
      for (int jj = SP - 1; jj >= 0; --jj) {
        const float4 a = sl.ta(jj), b = sl.tb(jj);
        const float nm = fmaf(dn, b.z, fmaf(iv[jj], b.x, ne + s0));
        const float ni = fmaf(iv[jj], b.y, s1);
        dn = fmaf(dn, b.w, ne + s2);
        s0 = m[jj] * a.x;
        s1 = m[jj] * a.y;
        s2 = m[jj] * a.z;
        m[jj] = nm * inv;
        iv[jj] = ni * inv;
        ml = fmaxf(ml, m[jj]);
      }
      xJ = nj * inv;
      xC = nc * inv;
      xN = nn * inv;
      xB = B * inv;
      xE = ne * inv;
      mprev = fmaxf(fmaxf(ml, xJ), fmaxf(xC, xN));
      if (lane == r - r0) {
        sB = xB;
        sE = xE;
        sN = xN;
        sJ = xJ;
        sC = xC;
        sR = (float)ls2 * LN2;
      }
      if constexpr (PREFETCH) {
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) ec[jj] = en[jj];
      }
    }
    // the decode terms of the block's rows, one row a lane
    if (mine) {
      const float ex1 = expf(rs1 + sR - fs);
      float tB = fB * sB * ex1, tE = 0.f, tW = 0.f;
      if (q > 0) {
        tE = fE * sE * ex1;
        const float ex0 = expf(rs0 + sR - fs);
        const float en = expf((float)(q - 1) * log_loop + sR - fs);
        tW = (en * sN + (fJ0 * sJ + fC0 * sC) * ex0) * loop;
      }
      float* t = tm + (size_t)q * NT;
      t[0] = live ? tB : 0.f;
      t[1] = live ? tE : 0.f;
      t[2] = live ? tW : 0.f;
    }
  }
  if (threadIdx.x % (32 * NWS) == 0)
    bsc[w] = xN > 0.f ? logf(xN) + (float)ls2 * LN2 : NEGMASS;
}

// The block route's resident pairs on this card: blocks a SM (at the
// backward kernel's registers and shared memory) times the SMs.
template <int S>
static int block_capacity() {
  static int cap = -1;
  if (cap < 0) {
    constexpr int NW = rows_warps(S);
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bck_rows_kernel<S, NW>, 32 * NW, 0);
    cap = blocks * sms;
  }
  return cap;
}

template <int S, int NW>
static int launch_pass(const void* codes, int Lmax, const void* lens,
                       const void* lm, const void* emis, const void* trans,
                       const void* pair_p, const void* pair_row, int npairs,
                       int Kp, void* frows, void* fsc, void* terms,
                       void* bsc, cudaStream_t stream) {
  const int grid =
      NW == 1 ? (npairs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK : npairs;
  const int threads = 32 * (NW == 1 ? WARPS_PER_BLOCK : NW);
  fwd_rows_kernel<S, NW><<<grid, threads, 0, stream>>>(
      (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)lm,
      (const float2*)emis, (const float4*)trans, (const int*)pair_p,
      (const int*)pair_row, npairs, Kp, (float*)frows, (float*)fsc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bck_rows_kernel<S, NW><<<grid, threads, 0, stream>>>(
      (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)lm,
      (const float2*)emis, (const float4*)trans, (const int*)pair_p,
      (const int*)pair_row, npairs, Kp, (const float*)frows,
      (const float*)fsc, (float*)terms, (float*)bsc);
  return (int)cudaGetLastError();
}

// route: 1 one warp a pair, 2 the block route (from 12 slots a lane), 0
// the default: the block route where it exists and the launch's pairs
// all fit on the card at once, one warp a pair otherwise.
// The routes add the D->D sums in another order, so a pair's rows may
// move by a few ulps with the launch's size.
template <int S>
static int launch_rows(const void* codes, int Lmax, const void* lens,
                       const void* lm, const void* emis, const void* trans,
                       const void* pair_p, const void* pair_row, int npairs,
                       int Kp, int route, void* frows, void* fsc,
                       void* terms, void* bsc, cudaStream_t stream) {
  constexpr int NW = rows_warps(S);
  if (route == 0) route = NW > 1 && npairs <= block_capacity<S>() ? 2 : 1;
  if (route == 1)
    return launch_pass<S, 1>(codes, Lmax, lens, lm, emis, trans, pair_p,
                             pair_row, npairs, Kp, frows, fsc, terms, bsc,
                             stream);
  if (route == 2) {
    if constexpr (NW == 1) return (int)cudaErrorInvalidValue;
    else
      return launch_pass<S, NW>(codes, Lmax, lens, lm, emis, trans, pair_p,
                                pair_row, npairs, Kp, frows, fsc, terms,
                                bsc, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int rows_launch(const void* codes, int Lmax, const void* lens,
                           const void* lm, const void* emis,
                           const void* trans, const void* pair_p,
                           const void* pair_row, int npairs, int Kp, int S,
                           int route, void* frows, void* fsc, void* terms,
                           void* bsc, void* stream) {
  if (npairs <= 0) return 0;
  switch (S) {
#define PYHMMER_CASE(s)                                                    \
  case s:                                                                  \
    return launch_rows<s>(codes, Lmax, lens, lm, emis, trans, pair_p,      \
                          pair_row, npairs, Kp, route, frows, fsc, terms,  \
                          bsc, (cudaStream_t)stream);
    PYHMMER_ROWS_STRIPES(PYHMMER_CASE)
#undef PYHMMER_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
