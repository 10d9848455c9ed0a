// Forward filter score (odds space, parser score), multihit local.
//
// Replaces the TPU kernels pyhmmer_tpu/ops/fwd_pallas.py:_fwd3_body
// (profile-stacked, launched by _fwd_pallas3), _fwd2_body (per profile,
// launched by _fwd_pallas2) and _fwd_body (v1, launched by _fwd_pallas,
// its D->D chain an [Mp, Mp] transfer matmul per row), and the XLA scan
// ops/batch.py:_forward_kernel that serves long buckets and Mp > 768.
//
// Semantics: HMMER's odds-space Forward parser in f32.  Every row is
// rescaled by s = max(E, J, C, N): the cells are multiplied by a factor
// f near 1 / s, and the log of the factor applied is accumulated, so the
// score is log C - sum log f + log move, or NEGMASS when C is 0.  The
// sum of logs is kept in double: over a long target the per-row logs are
// nearly equal, so an f32 sum rounds the same way row after row (0.041
// nats off the f64 oracle on a 35,000-residue target at Mk 1,024, where
// the double sum is 0.0009 off), and two f32 sums of slightly different
// rows drift apart (PERF.md, Findings).  E sums
// every M and D state (the TPU kernels fold the D part into a weight row
// w_e; here D is computed explicitly).  Per-target length model: loop
// odds L/(L+3), move odds 3/(L+3).
//
// Layout: one warp scores one (profile, target) pair; lane l holds the
// stripe of S = Mk / 32 model slots l*S .. l*S+S-1 in registers (M, I
// and D).  The D->D chain d[s+1] = m[s] * tMD + d[s] * tDD is an exact
// O(Mk) linear recurrence: each lane runs it over its stripe with 0
// entering (the partial row dl), one 5-step warp scan composes the
// stripes' affine maps and sums E at the same time (below), and the
// value entering the stripe is added back as d_in * pre[j] (pre[j]: the
// product of the stripe's tDD before slot j).  pre[j] and the scan's
// multipliers depend on the model only: they are computed once per pair
// (in double, then rounded).  (The
// TPU kernels applied an O(Mk^2) transfer matrix per row because the MXU
// made it cheap; the scan does O(Mk) work.)
//
// Bound on this card: the latency of each row's dependency chain -- not
// bytes, and not instruction issue.  The stage-2 launches of a search
// hold a few hundred to a few thousand pairs (the survivors of stage 1),
// so the card holds every warp at once and most SMs run a few warps: a
// row's shuffles, loads and serial adds are not hidden.  The first
// version of this kernel issued 10-12 loads per slot and row and, per
// row, 11 shuffles in series (a 5-step scan with two shuffles a step, the
// D edge, a 5-step E sum), a division, and the stripe's D chain twice.
// The design against that:
//
// * Packed tables (ops/batch.py: fwd_emis, fwd_trans): one slot's M and
//   I emission odds for one residue in one float2 load, its eight
//   transition odds in two float4 loads, each contiguous over the warp;
//   models up to 256 slots keep their transitions in registers, so a row
//   loads only its emissions, and up to 512 slots the next row's
//   emissions are loaded before this row's DP, off the chain.
// * One scan instead of two: for a window of lanes, the map from the D
//   value x entering it to (D leaving it, the window's share of E) is
//   (x A + B, x W + C); step k joins the window 2^k lanes below with
//   B += B' A, C += C' + B' W, where A and W do not depend on the row.
//   6 shuffles in series a row instead of 11, and the stripe's D chain
//   is run once.
// * The stripe's E terms go to four partial sums, not one serial chain;
//   1/max is an approximate reciprocal (the score adds the log of the
//   factor that was applied, so its rounding does not reach the score).
//
// * The block route, for S >= FWD_WIDE_S (models of 1,024 to 4,096
//   slots): fwd_block_kernel, NW warps a pair, SP = S / NW = 8 slots a
//   thread (more from S = 96).  Its first version, fwd_wide_kernel, kept
//   a lane's whole stripe of 32-128 slots in one thread and spilled from
//   S = 64 (8,128 bytes of spill stores at S = 128); a row also ran two
//   passes over the stripe, a 5-step scan and a 5-step E sum, in series,
//   on one warp a pair.  The block route keeps each thread's 8-16 slots
//   out of device memory (in registers; at S = 128 the D cells in shared
//   memory), with no spill at any width, runs fwd_kernel's one scan on
//   the lanes' maps after composing the NW warps of a lane through
//   shared memory, with one barrier a row, and puts NW times the warps
//   on a pair's chain.  It measured faster than fwd_wide_kernel at every
//   launch, one of 3,396 pairs (more than the card holds at once)
//   included, and than fwd_cta_kernel run at 1,024 slots (PERF.md,
//   Findings), so it is the one route from S = 32.
//
// Models over 4,096 slots take the wide route, fwd_cta_kernel (below).
//
// Several targets a warp (8 or 16 lanes a target for narrow models, as
// msv.cu does) was built and measured: it won only at the launches with
// more than about 4,000 pairs and lost at the others, since a latency-
// bound launch with fewer warps hides less (PERF.md, Findings).

#include "common.cuh"

constexpr float TINY = 1e-30f;
// stripe width from which the tables take the wide layout and the block
// route runs (ops/batch.py:FWD_WIDE_S)
constexpr int FWD_WIDE_S = 32;

template <int S>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
fwd_kernel(const uint8_t* __restrict__ codes, int Lmax,
           const int* __restrict__ lens, const float* __restrict__ lm,
           const float2* __restrict__ emis,   // [P, Kp, S, 32] (M, I) odds
           const float4* __restrict__ trans,  // [P, S, 2, 32] 8 odds a slot
           const int* __restrict__ pair_p, const int* __restrict__ pair_row,
           const int* __restrict__ pair_out, int npairs, int Kp,
           float* __restrict__ out) {
  constexpr bool TR_REGS = S <= 8;     // transitions in registers
  constexpr bool PRE_REGS = S <= 16;   // pre[j] in registers
  constexpr bool PREFETCH = S <= 16;   // next row's emissions ahead
  constexpr int NACC = S >= 8 ? 4 : 1;  // partial sums of E
  const int w = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (w >= npairs) return;
  const int lane = threadIdx.x & 31;
  const int p = pair_p[w], row = pair_row[w];
  const int L = lens[row];
  const float loop = lm[row * 4 + 0], move = lm[row * 4 + 1];
  const float log_move = lm[row * 4 + 3];
  // slot j of this lane: transitions TR[64 j] (tMM, tIM, tDM, tBM) and
  // TR[64 j + 32] (tMI, tII, tMD, tDD); emissions of code x EM[32 (x S + j)]
  const float4* TR = trans + (size_t)p * S * 64 + lane;
  const float2* EM = emis + (size_t)p * Kp * S * 32 + lane;
  float4 tra[TR_REGS ? S : 1], trb[TR_REGS ? S : 1];
  if constexpr (TR_REGS) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      tra[j] = __ldg(TR + 64 * j);
      trb[j] = __ldg(TR + 64 * j + 32);
    }
  }
  auto ta = [&](int j) {
    if constexpr (TR_REGS) return tra[j];
    else return __ldg(TR + 64 * j);
  };
  auto tb = [&](int j) {
    if constexpr (TR_REGS) return trb[j];
    else return __ldg(TR + 64 * j + 32);
  };
  auto load_emis = [&](int x, float2* e) {
    const float2* ex = EM + (size_t)x * S * 32;
#pragma unroll
    for (int j = 0; j < S; ++j) e[j] = __ldg(ex + 32 * j);
  };

  // the row-invariant D->D terms (in double, rounded once): pre[j]; the
  // stripe's product A and the sum W of pre; the scan's multipliers
  float pre[PRE_REGS ? S : 1];
  double A = 1.0, W = 0.0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if constexpr (PRE_REGS) pre[j] = (float)A;
    W += A;
    A *= tb(j).w;
  }
  float amul[5], wmul[5], cmul[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double Ap = __shfl_up_sync(FULL_MASK, A, 1 << k);
    const double Wp = __shfl_up_sync(FULL_MASK, W, 1 << k);
    const bool has = lane >= (1 << k);  // 0 where there is none: no branch
    amul[k] = has ? (float)A : 0.f;
    wmul[k] = has ? (float)W : 0.f;
    cmul[k] = has ? 1.f : 0.f;
    if (has) {
      W = W * Ap + Wp;
      A *= Ap;
    }
  }

  float m[S], iv[S], d[S];
#pragma unroll
  for (int j = 0; j < S; ++j) m[j] = iv[j] = d[j] = 0.f;
  float xN = 1.f, xB = move, xJ = 0.f, xC = 0.f;
  double lsc = 0.0;  // the logs of the scales applied, summed

  const uint8_t* seq = codes + (size_t)row * Lmax;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int nr = min(32, L - i0);
    const int mycode = lane < nr ? (int)seq[i0 + lane] : 0;
    float2 ec[S];
    if constexpr (PREFETCH) load_emis(__shfl_sync(FULL_MASK, mycode, 0), ec);
    for (int r = 0; r < nr; ++r) {
      // the next row's emissions, off this row's dependency chain (the
      // last row of a block loads one it does not use)
      float2 en[PREFETCH ? S : 1];
      if constexpr (PREFETCH)
        load_emis(__shfl_sync(FULL_MASK, mycode, (r + 1) & 31), en);
      else
        load_emis(__shfl_sync(FULL_MASK, mycode, r), ec);
      float pm = __shfl_up_sync(FULL_MASK, m[S - 1], 1);
      float pi = __shfl_up_sync(FULL_MASK, iv[S - 1], 1);
      float pd = __shfl_up_sync(FULL_MASK, d[S - 1], 1);
      if (lane == 0) pm = pi = pd = 0.f;
      // M and I from the previous row; D with 0 entering the stripe
      float dl = 0.f, es[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) es[k] = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float4 a = ta(j), b = tb(j);
        const float2 e = ec[j];
        const float om = m[j], oi = iv[j], od = d[j];
        const float nm = e.x * (pm * a.x + pi * a.y + pd * a.z + xB * a.w);
        m[j] = nm;
        iv[j] = e.y * (om * b.x + oi * b.y);
        d[j] = dl;
        es[j % NACC] += nm + dl;
        dl = dl * b.w + nm * b.z;
        pm = om;
        pi = oi;
        pd = od;
      }
      float C = es[0];
#pragma unroll
      for (int k = 1; k < NACC; ++k) C += es[k];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float Bp = __shfl_up_sync(FULL_MASK, dl, 1 << k);
        const float Cp = __shfl_up_sync(FULL_MASK, C, 1 << k);
        C = fmaf(cmul[k], Cp, fmaf(wmul[k], Bp, C));
        dl = fmaf(amul[k], Bp, dl);
      }
      float dd = __shfl_up_sync(FULL_MASK, dl, 1);  // D entering the stripe
      if (lane == 0) dd = 0.f;
      const float e = __shfl_sync(FULL_MASK, C, 31);  // E of the row
      const float nj = xJ * loop + e * 0.5f;
      const float nc = xC * loop + e * 0.5f;
      const float nn = xN * loop;
      const float nb = (nn + nj) * move;
      const float mx = fmaxf(fmaxf(fmaxf(e, nj), fmaxf(nc, nn)), TINY);
      const float inv = __fdividef(1.f, mx);
      // the D row (what enters the stripe added back), then the rescale
      if constexpr (PRE_REGS) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          m[j] *= inv;
          iv[j] *= inv;
          d[j] = fmaf(dd, pre[j], d[j]) * inv;
        }
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          m[j] *= inv;
          iv[j] *= inv;
          d[j] = (d[j] + dd) * inv;
          dd *= tb(j).w;
        }
      }
      lsc -= logf(inv);
      xJ = nj * inv;
      xC = nc * inv;
      xN = nn * inv;
      xB = nb * inv;
      if constexpr (PREFETCH) {
#pragma unroll
        for (int j = 0; j < S; ++j) ec[j] = en[j];
      }
    }
  }
  if (lane == 0)
    out[pair_out[w]] =
        xC > 0.f ? (float)(lsc + logf(xC) + log_move) : NEGMASS;
}

// the block route's slots a thread and most warps a pair
constexpr int FWD_BLOCK_SP = 8;
constexpr int FWD_BLOCK_WARPS = 8;
// warps a pair on the block route: FWD_BLOCK_SP slots a thread, at most
// FWD_BLOCK_WARPS warps (more slots a thread from S = 96)
__host__ __device__ constexpr int fwd_warps(int S) {
  return S / FWD_BLOCK_SP <= FWD_BLOCK_WARPS ? S / FWD_BLOCK_SP
                                             : FWD_BLOCK_WARPS;
}

// The block route, models of 32 slots a lane and more (Mk 1,024-4,096):
// NW warps score one pair, thread (warp wi, lane l) the SP = S / NW
// stripe positions wi*SP .. wi*SP+SP-1 of lane l, i.e. the slots l*S +
// wi*SP + jj, over the wide layout of the packed tables (emis [P, Kp, 2,
// S, 32]: the M then the I odds of a residue, striped; trans [P, 8, S,
// 32]: one striped table per transition), so each load stays contiguous
// over a warp.  The slots run lane-major: warp wi of lane l follows warp
// wi - 1 of lane l, and warp 0 of lane l follows warp NW - 1 of lane
// l - 1.  A row: each thread runs M and I over its slots and the D chain
// with 0 entering, giving its map x -> (x A + B, C + x W) (fwd_kernel's
// maps; A and W depend on the model only), writes (B, C) and its last
// slot's cells to shared memory, one barrier; every thread then composes
// its lane's NW maps (the lane's map and the prefixes below itself and
// below the thread under it), the warps scan the lanes' maps as
// fwd_kernel does (each warp the same scan, so every thread gets the
// same E and scale), and each thread derives the D entering itself and
// the previous row's last slot of the thread below it (its local D plus
// the D that entered it times its D->D product).  Buffers alternate by
// row, so one barrier a row is enough.  The row-invariant terms (pre[jj],
// each thread's A and W, their compositions over a lane's warps and the
// lane scan's multipliers) are formed once a pair in double, then
// rounded.  A thread holds its SP M and I cells in registers and, up to
// 12 slots a thread, its D cells and SP pre terms too (beyond, the D
// cells live in shared memory and the D row is carried down the
// thread's slots, as fwd_kernel does past 16: with all three rows in
// registers, 16 slots a thread spilled 8-16 bytes at 255 registers, and
// 16 warps of 8 slots, at 128 registers a thread, 152); up to 8 slots a
// thread its transitions live in registers (else it reads them through
// L1 every row), and up to 12 the next row's emissions load during this
// row, off the chain.
template <int S>
__global__ void __launch_bounds__(32 * fwd_warps(S), 1)
fwd_block_kernel(const uint8_t* __restrict__ codes, int Lmax,
                 const int* __restrict__ lens, const float* __restrict__ lm,
                 const float* __restrict__ emis,  // [P, Kp, 2, S, 32] odds
                 const float* __restrict__ tr,    // [P, 8, S, 32] odds
                 const int* __restrict__ pair_p,
                 const int* __restrict__ pair_row,
                 const int* __restrict__ pair_out, int Kp,
                 float* __restrict__ out) {
  constexpr int NW = fwd_warps(S), SP = S / NW;
  constexpr bool TR_REGS = SP <= 8;    // transitions in registers
  constexpr bool PRE_REGS = SP <= 12;  // D->D prefix products in registers
  constexpr bool D_REGS = SP <= 12;    // D cells in registers
  constexpr bool PREFETCH = SP <= 12;  // next row's emissions ahead
  constexpr int NACC = 4;              // partial sums of E
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int w = blockIdx.x;
  const int p = pair_p[w], row = pair_row[w];
  const int L = lens[row];
  const float loop = lm[row * 4 + 0], move = lm[row * 4 + 1];
  const float log_move = lm[row * 4 + 3];
  // this thread's slot jj is stripe position wi*SP + jj of lane `lane`:
  // transition t at T[(t S + jj) 32], emissions of code x at EM[(2 x S +
  // jj) 32] (M) and EM[((2 x + 1) S + jj) 32] (I)
  const float* T = tr + ((size_t)p * 8 * S + wi * SP) * 32 + lane;
  const float* EM = emis + ((size_t)p * Kp * 2 * S + wi * SP) * 32 + lane;
  auto ld_t = [&](int t, int jj) { return __ldg(T + (t * S + jj) * 32); };
  float4 tra[TR_REGS ? SP : 1], trb[TR_REGS ? SP : 1];
  if constexpr (TR_REGS) {
#pragma unroll
    for (int jj = 0; jj < SP; ++jj) {
      tra[jj] = make_float4(ld_t(0, jj), ld_t(1, jj), ld_t(2, jj),
                            ld_t(3, jj));
      trb[jj] = make_float4(ld_t(4, jj), ld_t(5, jj), ld_t(6, jj),
                            ld_t(7, jj));
    }
  }
  // (tMM, tIM, tDM, tBM) and (tMI, tII, tMD, tDD) of slot jj
  auto ta = [&](int jj) {
    if constexpr (TR_REGS) return tra[jj];
    else return make_float4(ld_t(0, jj), ld_t(1, jj), ld_t(2, jj),
                            ld_t(3, jj));
  };
  auto tb = [&](int jj) {
    if constexpr (TR_REGS) return trb[jj];
    else return make_float4(ld_t(4, jj), ld_t(5, jj), ld_t(6, jj),
                            ld_t(7, jj));
  };
  auto load_emis = [&](int x, float2* e) {
    const float* em = EM + (size_t)x * 2 * S * 32;
#pragma unroll
    for (int jj = 0; jj < SP; ++jj)
      e[jj] = make_float2(__ldg(em + jj * 32), __ldg(em + (S + jj) * 32));
  };

  // this thread's row-invariant terms: pre[jj], the product of its D->D
  // odds before slot jj; A, their whole product; W, the sum of pre
  float pre[PRE_REGS ? SP : 1], pre_last = 1.f;
  double A = 1.0, W = 0.0;
#pragma unroll
  for (int jj = 0; jj < SP; ++jj) {
    if constexpr (PRE_REGS) pre[jj] = (float)A;
    pre_last = (float)A;
    W += A;
    A *= tb(jj).w;
  }
  // the pair's shared state: per thread its (A, W) in double and rounded,
  // and by row parity its map (B, C) and its last slot (M, I, local D)
  __shared__ double2 sAW[NW][32];
  __shared__ float2 sAWf[NW][32];
  __shared__ float sPre[NW][32];
  __shared__ float2 sBC[2][NW][32];
  __shared__ float4 sCar[2][NW][32];
  sAW[wi][lane] = make_double2(A, W);
  sAWf[wi][lane] = make_float2((float)A, (float)W);
  sPre[wi][lane] = pre_last;
  __syncthreads();
  // compose this lane's column of warps: the product of A below this
  // thread (Aown), below the thread under it (Apred) and below the
  // lane's last warp (Aq, taken from the lane under this one); the
  // lane's whole map (A, W); pre of the last slot below this thread
  double Ar = 1.0, Wr = 0.0, Aown = 1.0, Apred = 1.0, Aq = 1.0;
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    if (v == wi - 1) Apred = Ar;
    if (v == wi) Aown = Ar;
    if (v == NW - 1) Aq = Ar;
    const double2 aw = sAW[v][lane];
    Wr += Ar * aw.y;
    Ar *= aw.x;
  }
  const float fAown = (float)Aown, fApred = (float)Apred;
  const float fAq = __shfl_up_sync(FULL_MASK, (float)Aq, 1);
  const float pre_left = __shfl_up_sync(FULL_MASK, sPre[NW - 1][lane], 1);
  const float pre_pred = wi > 0 ? sPre[wi - 1][lane] : pre_left;
  // the lane scan's multipliers (fwd_kernel's, over the lanes' maps)
  float amul[5], wmul[5], cmul[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double Ap = __shfl_up_sync(FULL_MASK, Ar, 1 << k);
    const double Wp = __shfl_up_sync(FULL_MASK, Wr, 1 << k);
    const bool has = lane >= (1 << k);
    amul[k] = has ? (float)Ar : 0.f;
    wmul[k] = has ? (float)Wr : 0.f;
    cmul[k] = has ? 1.f : 0.f;
    if (has) {
      Wr = Wr * Ap + Wp;
      Ar *= Ap;
    }
  }

  // the cells of this thread's slots: M and I in registers, D too up to
  // 12 slots a thread, else in shared memory (element (jj, t), so a
  // warp's access is contiguous)
  float m[SP], iv[SP], d_regs[D_REGS ? SP : 1];
  __shared__ float sD[D_REGS ? 1 : SP][D_REGS ? 1 : 32 * NW];
  auto d = [&](int jj) -> float& {
    if constexpr (D_REGS) return d_regs[jj];
    else return sD[jj][threadIdx.x];
  };
#pragma unroll
  for (int jj = 0; jj < SP; ++jj) m[jj] = iv[jj] = d(jj) = 0.f;
  float xN = 1.f, xB = move, xJ = 0.f, xC = 0.f;
  double lsc = 0.0;  // the logs of the scales applied, summed
  // the previous row's scaled cells of the slot below this thread's first
  float cm = 0.f, ci = 0.f, cd = 0.f;
  const bool first = wi == 0 && lane == 0;  // holds the model's slot 0
  int par = 0;

  const uint8_t* seq = codes + (size_t)row * Lmax;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int nr = min(32, L - i0);
    const int mycode = lane < nr ? (int)seq[i0 + lane] : 0;
    float2 ec[SP];
    if constexpr (PREFETCH) load_emis(__shfl_sync(FULL_MASK, mycode, 0), ec);
    for (int r = 0; r < nr; ++r) {
      // the next row's emissions, off this row's dependency chain (the
      // last row of a block loads one it does not use)
      float2 en[PREFETCH ? SP : 1];
      if constexpr (PREFETCH)
        load_emis(__shfl_sync(FULL_MASK, mycode, (r + 1) & 31), en);
      else
        load_emis(__shfl_sync(FULL_MASK, mycode, r), ec);
      float pm = cm, pi = ci, pd = cd;
      // M and I from the previous row; D with 0 entering the thread's
      // slots (dl); C, the slots' share of E with 0 entering
      float dl = 0.f, es[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) es[k] = 0.f;
#pragma unroll
      for (int jj = 0; jj < SP; ++jj) {
        const float4 a = ta(jj), b = tb(jj);
        const float2 e = ec[jj];
        const float om = m[jj], oi = iv[jj], od = d(jj);
        const float nm = e.x * (pm * a.x + pi * a.y + pd * a.z + xB * a.w);
        m[jj] = nm;
        iv[jj] = e.y * (om * b.x + oi * b.y);
        d(jj) = dl;
        es[jj % NACC] += nm + dl;
        dl = dl * b.w + nm * b.z;
        pm = om;
        pi = oi;
        pd = od;
      }
      float C = es[0];
#pragma unroll
      for (int k = 1; k < NACC; ++k) C += es[k];
      // compose this lane's column of warps: its whole map, and the
      // prefixes below this thread, below the thread under it and below
      // the lane's last warp (with 0 entering the lane)
      sBC[par][wi][lane] = make_float2(dl, C);
      sCar[par][wi][lane] = make_float4(m[SP - 1], iv[SP - 1], d(SP - 1),
                                        0.f);
      __syncthreads();
      float B = 0.f, Bown = 0.f, Bpred = 0.f, Bq = 0.f;
      C = 0.f;
#pragma unroll
      for (int v = 0; v < NW; ++v) {
        if (v == wi - 1) Bpred = B;
        if (v == wi) Bown = B;
        if (v == NW - 1) Bq = B;
        const float2 bc = sBC[par][v][lane];
        const float2 aw = sAWf[v][lane];
        C = fmaf(B, aw.y, C + bc.y);
        B = fmaf(B, aw.x, bc.x);
      }
      const float4 car = sCar[par][wi > 0 ? wi - 1 : NW - 1]
                             [wi > 0 ? lane : max(lane - 1, 0)];
      par ^= 1;
      // the lanes' maps, scanned
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
      const float dd = fmaf(X, fAown, Bown);  // D entering this thread
      // the D that entered the thread below (warp-uniform branch)
      float xp;
      if (wi > 0) {
        xp = fmaf(X, fApred, Bpred);
      } else {
        const float Xl = __shfl_up_sync(FULL_MASK, X, 1);
        const float Bql = __shfl_up_sync(FULL_MASK, Bq, 1);
        xp = fmaf(Xl, fAq, Bql);
      }
      const float nj = xJ * loop + e * 0.5f;
      const float nc = xC * loop + e * 0.5f;
      const float nn = xN * loop;
      const float nb = (nn + nj) * move;
      const float mx = fmaxf(fmaxf(fmaxf(e, nj), fmaxf(nc, nn)), TINY);
      const float inv = __fdividef(1.f, mx);
      // the D row (what entered the thread added back), then the rescale
      if constexpr (PRE_REGS) {
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) {
          m[jj] *= inv;
          iv[jj] *= inv;
          d(jj) = fmaf(dd, pre[jj], d(jj)) * inv;
        }
      } else {
        float x = dd;
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) {
          m[jj] *= inv;
          iv[jj] *= inv;
          d(jj) = (d(jj) + x) * inv;
          x *= tb(jj).w;
        }
      }
      // the next row's carry: the thread below's last slot, true, scaled
      cm = first ? 0.f : car.x * inv;
      ci = first ? 0.f : car.y * inv;
      cd = first ? 0.f : fmaf(xp, pre_pred, car.z) * inv;
      lsc -= logf(inv);
      xJ = nj * inv;
      xC = nc * inv;
      xN = nn * inv;
      xB = nb * inv;
      if constexpr (PREFETCH) {
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) ec[jj] = en[jj];
      }
    }
  }
  if (threadIdx.x == 0)
    out[pair_out[w]] =
        xC > 0.f ? (float)(lsc + logf(xC) + log_move) : NEGMASS;
}

// The wide route (models over 4,096 slots; the design in common.cuh, which
// vit_cta_kernel shares): its first version was bound by the L2 bytes of
// the tables it reads every row, 40 a slot, and of its scratch row, so it
// reads the tables thread-major, one float2 and two float4 a slot
// contiguous over the CTA, and keeps the row's cells out of device memory;
// now each row's instructions and latency bound it.  One CTA of NT threads
// a pair, thread t the run of SPT slots t*SPT .. t*SPT+SPT-1, its M, I and
// D in registers (SPT > 0, the ladder PYHMMER_CTA_REGS: up to 5,632 slots)
// or in a row of shared (up to CTA_SMEM_SLOTS) or global memory (SPT = 0,
// the run length a.spt).  A thread runs M and I over its slots and the D
// chain with 0 entering, giving its map x -> x A + B (A the product of its
// D->D odds) and its share of E, C + x W (W the sum of the D->D products
// before each slot); cta_scan composes them, giving E, the row's scale and
// the D entering each thread.  The cells hold each slot's unscaled M, I
// and local D: the next row forms the true, scaled values as it reads them
// ((D + X pre) / max of the row).  The float operations of a cell are the
// plain version's, in order; the D chain is summed in another order (per
// thread, then by the scan), so the score differs from it by f32 rounding
// only.
template <int NT, int SPT>
__global__ void __launch_bounds__(NT, 1)
fwd_cta_kernel(const CtaArgs a, float* __restrict__ scratch) {
  // per row parity: each warp's map and E share, lane 30's inclusive map,
  // lane 31's last cells; the thread below's D->D product
  __shared__ float4 sW[2][NT / 32];
  __shared__ float2 s30[2][NT / 32];
  __shared__ float4 sLast[2][NT / 32];
  __shared__ float sPre[NT / 32];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int n = SPT ? SPT : a.spt;
  extern __shared__ float dyn_rows[];
  float* rows = nullptr;
  if constexpr (SPT == 0)
    rows = (scratch ? scratch + (size_t)blockIdx.x * 3 * n * NT
                    : dyn_rows) + t;
  CtaCells<SPT, NT> cell(rows, n);
  for (int w = blockIdx.x; w < a.npairs; w += gridDim.x) {
    const int p = a.pair_p[w], row = a.pair_row[w];
    const int L = a.lens[row];
    const float loop = a.lm[row * 4 + 0], move = a.lm[row * 4 + 1];
    const float log_move = a.lm[row * 4 + 3];
    const float4* TR = a.trans + (size_t)p * n * 2 * NT + t;
    const float2* EM = a.emis + (size_t)p * a.Kp * n * NT + t;
    // the D->D product over this thread's slots but the last (for the
    // thread above), and the thread below's (lane 0)
    float own_pre_last;
    const float nb_pre =
        cta_pre_last<OddsMaps, NT>(TR, n, sPre, &own_pre_last);
#pragma unroll
    for (int j = 0; j < n; ++j)
      cell.at(0, j) = cell.at(1, j) = cell.at(2, j) = 0.f;
    float xN = 1.f, xB = move, xJ = 0.f, xC = 0.f;
    double lsc = 0.0;  // the logs of the scales applied, summed
    // the previous row's scaled cells of slot t*SPT - 1, the D that
    // entered this thread's slots (unscaled) and the row's scale
    float cm = 0.f, ci = 0.f, cd = 0.f, Xprev = 0.f, sc = 1.f;
    int par = 0;
    const uint8_t* seq = a.codes + (size_t)row * a.Lmax;
    for (int i = 0; i < L; ++i) {
      const float2* em = EM + (size_t)__ldg(seq + i) * n * NT;
      float pm = cm, pi = ci, pd = cd;
      float dl = 0.f, C = 0.f, W = 0.f, pre = 1.f;
      float lm_ = 0.f, li_ = 0.f, ld_ = 0.f;
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const float4 ta = __ldg(TR + (size_t)(2 * j) * NT);
        const float4 tb = __ldg(TR + (size_t)(2 * j + 1) * NT);
        const float2 e = __ldg(em + (size_t)j * NT);
        const float om = cell.at(0, j) * sc;
        const float oi = cell.at(1, j) * sc;
        const float od = fmaf(Xprev, pre, cell.at(2, j)) * sc;
        const float nm = e.x * (pm * ta.x + pi * ta.y + pd * ta.z +
                                xB * ta.w);
        const float ni = e.y * (om * tb.x + oi * tb.y);
        cell.at(0, j) = nm;
        cell.at(1, j) = ni;
        cell.at(2, j) = dl;
        lm_ = nm;
        li_ = ni;
        ld_ = dl;
        C += nm + dl;
        W += pre;
        dl = dl * tb.w + nm * tb.z;
        pre *= tb.w;
        pm = om;
        pi = oi;
        pd = od;
      }
      const CtaRow r = cta_scan<OddsMaps, NT / 32>(
          pre, dl, C, W, make_float4(lm_, li_, ld_, 0.f), sW[par], s30[par],
          sLast[par]);
      const float nj = xJ * loop + r.E * 0.5f;
      const float nc = xC * loop + r.E * 0.5f;
      const float nn = xN * loop;
      const float nb = (nn + nj) * move;
      const float mx = fmaxf(fmaxf(fmaxf(r.E, nj), fmaxf(nc, nn)), TINY);
      const float inv = 1.f / mx;
      lsc -= logf(inv);
      xJ = nj * inv;
      xC = nc * inv;
      xN = nn * inv;
      xB = nb * inv;
      // this row's true cells of slot t*SPT - 1: the thread below's last
      // slot, by shuffle, or for lane 0 from lane 31's copy
      cm = __shfl_up_sync(FULL_MASK, lm_ * inv, 1);
      ci = __shfl_up_sync(FULL_MASK, li_ * inv, 1);
      cd = __shfl_up_sync(FULL_MASK, fmaf(r.Xt, own_pre_last, ld_) * inv, 1);
      if (lane == 0) {
        if (wid > 0) {
          const float4 q = sLast[par][wid - 1];
          cm = q.x * inv;
          ci = q.y * inv;
          cd = fmaf(r.Xnb, nb_pre, q.z) * inv;
        } else {
          cm = ci = cd = 0.f;
        }
      }
      Xprev = r.Xt;
      sc = inv;
      par ^= 1;
    }
    if (t == 0)
      a.out[a.pair_out[w]] =
          xC > 0.f ? (float)(lsc + logf(xC) + log_move) : NEGMASS;
  }
}

// one warp a pair (fwd_kernel) below FWD_WIDE_S slots a lane, the block
// route (fwd_block_kernel) from there
template <int S>
static int launch_fwd(const void* codes, int Lmax, const void* lens,
                      const void* lm, const void* emis, const void* trans,
                      const void* pair_p, const void* pair_row,
                      const void* pair_out, int npairs, int Kp, void* out,
                      cudaStream_t stream) {
  if constexpr (S < FWD_WIDE_S)
    fwd_kernel<S><<<(npairs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
                    32 * WARPS_PER_BLOCK, 0, stream>>>(
        (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)lm,
        (const float2*)emis, (const float4*)trans, (const int*)pair_p,
        (const int*)pair_row, (const int*)pair_out, npairs, Kp,
        (float*)out);
  else
    fwd_block_kernel<S><<<npairs, 32 * fwd_warps(S), 0, stream>>>(
        (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)lm,
        (const float*)emis, (const float*)trans, (const int*)pair_p,
        (const int*)pair_row, (const int*)pair_out, Kp, (float*)out);
  return (int)cudaGetLastError();
}

// A width that is not compiled (PYHMMER_STRIPES) is refused.
extern "C" int fwd_launch(const void* codes, int Lmax, const void* lens,
                          const void* lm, const void* emis,
                          const void* trans, const void* pair_p,
                          const void* pair_row, const void* pair_out,
                          int npairs, int Kp, int S, void* out,
                          void* stream) {
  if (npairs <= 0) return 0;
  if (S == 0) return (int)cudaErrorInvalidValue;  // fwd_cta_launch
  switch (S) {
#define PYHMMER_CASE(s)                                                   \
  case s:                                                                 \
    return launch_fwd<s>(codes, Lmax, lens, lm, emis, trans, pair_p,      \
                         pair_row, pair_out, npairs, Kp, out,             \
                         (cudaStream_t)stream);
    PYHMMER_STRIPES(PYHMMER_CASE)
#undef PYHMMER_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Warps a pair of the block route at S slots a lane; 0 where S has no
// block route (one warp a pair below FWD_WIDE_S, or not compiled).
extern "C" int fwd_block_warps(int S) {
  switch (S) {
#define PYHMMER_CASE(s) \
  case s:               \
    return s >= FWD_WIDE_S ? fwd_warps(s) : 0;
    PYHMMER_STRIPES(PYHMMER_CASE)
#undef PYHMMER_CASE
    default:
      return 0;
  }
}

// The wide route: the row in registers for the run lengths of the ladder,
// else in shared memory up to CTA_SMEM_SLOTS slots, else in scratch (3 *
// Mk floats for each of nctas CTAs; NULL is refused there).
extern "C" int fwd_cta_launch(const void* codes, int Lmax, const void* lens,
                              const void* lm, const void* emis,
                              const void* trans, const void* pair_p,
                              const void* pair_row, const void* pair_out,
                              int npairs, int Kp, int Mk, int nt,
                              void* out, void* scratch, int nctas,
                              void* stream) {
  if (npairs <= 0) return 0;
  if (Mk <= 0 || nt <= 0 || Mk % nt || Mk % CTA_THREADS || nctas <= 0)
    return (int)cudaErrorInvalidValue;
  const int spt = Mk / nt;
  const CtaArgs a{(const uint8_t*)codes, Lmax, (const int*)lens,
                  (const float*)lm, (const float2*)emis,
                  (const float4*)trans, (const int*)pair_p,
                  (const int*)pair_row, (const int*)pair_out, npairs, Kp,
                  spt, (float*)out};
  const cudaStream_t st = (cudaStream_t)stream;
#define PYHMMER_CASE(t, s)                                                 \
  if (nt == t && spt == s)                                                 \
    return cta_launch(fwd_cta_kernel<t, s>, t, a, nullptr, 0, nctas, st);
  PYHMMER_CTA_REGS(PYHMMER_CASE)
#undef PYHMMER_CASE
  if (nt != CTA_THREADS) return (int)cudaErrorInvalidValue;
  if (Mk <= CTA_SMEM_SLOTS)
    return cta_launch(fwd_cta_kernel<CTA_THREADS, 0>, nt, a, nullptr,
                      3 * Mk * (int)sizeof(float), nctas, st);
  if (!scratch) return (int)cudaErrorInvalidValue;
  return cta_launch(fwd_cta_kernel<CTA_THREADS, 0>, nt, a,
                    (float*)scratch, 0, nctas, st);
}
