// Viterbi filter score (log space, max-plus), multihit local.
//
// Replaces the TPU kernel pyhmmer_tpu/ops/vit_pallas.py:_vit_body
// (launched by _vit_pallas, its D->D chain a log2(Mp)-level shifted-max
// scan over sublanes) and the XLA scan ops/batch.py:_viterbi_kernel that
// serves long buckets and Mp > 768.
//
// Semantics: p7_ViterbiFilter in f32 -- xN starts at 0 and xB at log
// move, E collects from every M and D state, E->J = E->C = log 1/2, and
// the score is xC + log move, with the per-target length model's log
// loop and move read from lm (columns 2 and 3).  Emissions are full f32:
// the F2 gate downstream is strict.
//
// Layout: lane l of a warp holds the contiguous stripe of S model slots
// l*S .. l*S+S-1 of the M, I and D rows in registers, and reads them from
// the packed tables (ops/batch.py: vit_emis, vit_trans): one slot's M and
// I emission scores in one float2, its eight transitions in two float4,
// each contiguous over the warp; from S = VIT_WIDE_S on one striped float
// a value, contiguous over the warp all the same.
//
// Bound on this card: the latency of each row's dependency chain, not
// bytes and not instruction issue.  The main path's launches hold a few
// dozen (profile, target) pairs (PERF.md), so most SMs run one warp or
// none, and a long target is one pair that scans 35,000 rows in series.
// The first version of this kernel issued ten loads per slot and row (two
// emission tables, eight transitions re-read every row), about 14
// shuffles in series a row (3 carries, a 5-step scan with 2 shuffles a
// step, the D edge, a separate 5-step warp max for E), ran the stripe's D
// chain twice, and spilled registers from S = 24.  The design against
// that:
//
// * Packed tables: one to three loads per slot and row; models up to 256
//   slots keep their transitions in registers, and up to 12 slots a
//   thread the next row's emissions load during this row, off the chain.
// * One scan for the D chain and E.  For a window of slots, the map from
//   the D value x entering it to (D leaving it, the window's share of E)
//   is (max(x + A, B), max(x + W, C)); joining the lower window (A', B',
//   W', C') below it gives (A' + A, max(B' + A, B), max(W', A' + W),
//   max(C', B' + W, C)).  A, the window's D->D sum, depends on the model
//   only and is composed once per pair.  With log probabilities (every
//   transition <= 0) the rest simplifies: W, the largest D->D sum from
//   the window's first slot, is 0, and a D cell is an M cell of the same
//   row plus transitions, so the D part of E never exceeds the M part
//   (exactly, in f32 too).  So C is the window's largest M cell, a join
//   is max(C', C), each scan step shuffles B and C in parallel, and E is
//   lane 31's C: 8 shuffles in series a row, and the stripe's D chain
//   runs once.
// * The block route, for S >= VIT_WIDE_S: NW warps score one pair, SP =
//   S / NW = 8 slots a thread (more from S = 96).  Position j of the
//   stripe of lane l is held by warp j / SP, so every load stays
//   contiguous over a warp.  The slots run lane-major: warp w of lane l
//   follows warp w - 1 of lane l, and warp 0 of lane l follows warp NW - 1
//   of lane l - 1.  Each thread writes its map (B, C) and its last slot to
//   shared memory, one barrier a row; every thread then composes its
//   lane's NW maps (the lane's map and the prefixes below itself), the
//   warps scan the lanes' maps as above, and each thread derives the D
//   entering itself and the previous row's last slot of the thread below
//   it (whose D is max(beta, x + alpha): its local D and the
//   row-invariant D->D sum to it).  Buffers alternate by row, so one
//   barrier a row is enough.  A long target runs NW warps, and nothing
//   spills up to S = 96.  Where a launch has more pairs than the card
//   holds at once (S = 16 and 24: launch_vit), one warp a pair issues
//   less and is the default.
//
// * The wide route, vit_cta_kernel (models over 4,096 slots): one CTA a
//   pair, each thread a contiguous run of slots, on the design of
//   common.cuh, which fwd_cta_kernel shares: its first version was bound
//   by the L2 bytes of the tables it reads every row (40 a slot) and of
//   its scratch rows, so the tables are thread-major (one float2 of
//   emissions and two float4 of transitions a slot, contiguous over the
//   CTA), and the row's cells stay in registers up to 5,632 slots (in
//   shared memory up to 18,944, in a global scratch row beyond) instead of
//   passing through a global scratch of two rows every row; now each
//   row's instructions and latency bound it.  The scan is this file's (B,
//   C) map with A, the D->D sum over a thread's slots; one barrier a row.
//
// Values stay finite: I cells are clamped at NEGMASS; an M cell is at
// least xB + tBM + e, and a D cell, made anew from M every row, at least
// an M cell plus tMD: no cell falls below 3 NEGMASS, and the D->D sums
// (at least 4096 NEGMASS) stay far inside f32's range.  Slot 0 takes
// NEGMASS transitions from the slot below it, so lane 0 may take its own
// last slot as that slot.  A dead cell never wins a max against a live
// one.

#include "common.cuh"

constexpr float LOG_HALF = -0.69314718055994530942f;
// stripe width from which the tables take the wide layout
// (ops/batch.py:VIT_WIDE_S) and the block route compiles
constexpr int VIT_WIDE_S = 16;

// warps a pair on the block route: SP slots a thread, at most 8 warps
constexpr int vit_warps(int S, int SP) { return S / SP <= 8 ? S / SP : 8; }

// (a minimum of one block a SM: without it ptxas spills 4-12 bytes at
// 3-6 slots a lane, with under 128 registers)
template <int S, int NW, bool WIDE>
__global__ void __launch_bounds__(32 * (NW == 1 ? WARPS_PER_BLOCK : NW), 1)
vit_kernel(const uint8_t* __restrict__ codes, int Lmax,
           const int* __restrict__ lens, const float* __restrict__ lm,
           const float* __restrict__ emis,   // packed log emissions
           const float* __restrict__ trans,  // packed log transitions
           const int* __restrict__ pair_p, const int* __restrict__ pair_row,
           const int* __restrict__ pair_out, int npairs, int Kp,
           float* __restrict__ out) {
  constexpr int SP = S / NW;            // slots a thread
  constexpr bool TR_REGS = SP <= 8;     // transitions in registers
  constexpr bool PRE_REGS = SP <= 16;   // D->D prefix sums in registers
  constexpr bool PREFETCH = SP <= 12;   // next row's emissions ahead
  const int lane = threadIdx.x & 31;
  int w, wi;  // the pair; this thread's warp within the pair
  if constexpr (NW == 1) {
    w = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    wi = 0;
    if (w >= npairs) return;
  } else {
    w = blockIdx.x;
    wi = threadIdx.x >> 5;
  }
  const int j0 = wi * SP;  // this thread's first stripe position
  const int p = pair_p[w], row = pair_row[w];
  const int L = lens[row];
  const float loop = lm[row * 4 + 2], move = lm[row * 4 + 3];

  // slot jj of this thread is stripe position j0 + jj of lane `lane`
  auto ta = [&](int jj) -> float4 {
    const int j = j0 + jj;
    if constexpr (WIDE) {
      const float* t = trans + ((size_t)p * 8 * S + j) * 32 + lane;
      return make_float4(__ldg(t), __ldg(t + S * 32), __ldg(t + 2 * S * 32),
                         __ldg(t + 3 * S * 32));
    } else {
      return __ldg(reinterpret_cast<const float4*>(trans) +
                   ((size_t)p * S + j) * 64 + lane);
    }
  };
  auto tb = [&](int jj) -> float4 {
    const int j = j0 + jj;
    if constexpr (WIDE) {
      const float* t = trans + ((size_t)p * 8 * S + 4 * S + j) * 32 + lane;
      return make_float4(__ldg(t), __ldg(t + S * 32), __ldg(t + 2 * S * 32),
                         __ldg(t + 3 * S * 32));
    } else {
      return __ldg(reinterpret_cast<const float4*>(trans) +
                   ((size_t)p * S + j) * 64 + 32 + lane);
    }
  };
  auto load_emis = [&](int x, float2* e) {
    if constexpr (WIDE) {
      const float* em =
          emis + (((size_t)p * Kp + x) * 2 * S + j0) * 32 + lane;
#pragma unroll
      for (int jj = 0; jj < SP; ++jj)
        e[jj] = make_float2(__ldg(em + jj * 32), __ldg(em + (S + jj) * 32));
    } else {
      const float2* em = reinterpret_cast<const float2*>(emis) +
                         (((size_t)p * Kp + x) * S + j0) * 32 + lane;
#pragma unroll
      for (int jj = 0; jj < SP; ++jj) e[jj] = __ldg(em + jj * 32);
    }
  };

  float4 tra[TR_REGS ? SP : 1], trb[TR_REGS ? SP : 1];
  if constexpr (TR_REGS) {
#pragma unroll
    for (int jj = 0; jj < SP; ++jj) {
      tra[jj] = ta(jj);
      trb[jj] = tb(jj);
    }
  }
  auto TA = [&](int jj) {
    if constexpr (TR_REGS) return tra[jj];
    else return ta(jj);
  };
  auto TB = [&](int jj) {
    if constexpr (TR_REGS) return trb[jj];
    else return tb(jj);
  };

  // this thread's row-invariant map terms: pre[jj], the D->D sum from the
  // thread's first slot to slot jj; A, their total; alpha, the last pre
  float pre[PRE_REGS ? SP : 1];
  float A = 0.f, alpha = 0.f;
#pragma unroll
  for (int jj = 0; jj < SP; ++jj) {
    if constexpr (PRE_REGS) pre[jj] = A;
    alpha = A;
    A += TB(jj).w;
  }

  // the block route's shared state: per thread of the pair its
  // row-invariant (A, alpha) and, by row parity, its map (B, C) and its
  // last slot (m, i, local d)
  constexpr int NWS = NW == 1 ? 1 : NW;
  __shared__ float2 sA[NWS][32];
  __shared__ float2 sBC[2][NWS][32];
  __shared__ float4 sCar[2][NWS][32];
  // A of this lane's whole column of warps; the sums of A below this
  // thread, below the thread under it, and below the last warp of the
  // lane under this one; alpha of the thread under this one
  float AF = A, Aown = 0.f, Apred = 0.f, Aq = 0.f, alpha_pred = 0.f;
  if constexpr (NW > 1) {
    sA[wi][lane] = make_float2(A, alpha);
    __syncthreads();
    float Ar = 0.f, Aq_mine = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      if (v == wi - 1) Apred = Ar;
      if (v == wi) Aown = Ar;
      if (v == NW - 1) Aq_mine = Ar;
      Ar += sA[v][lane].x;
    }
    AF = Ar;
    Aq = __shfl_up_sync(FULL_MASK, Aq_mine, 1);
    const float alpha_left = __shfl_up_sync(FULL_MASK, sA[NW - 1][lane].y, 1);
    alpha_pred = wi > 0 ? sA[wi - 1][lane].y : alpha_left;
  }
  // the lane scan's row-invariant terms: this lane's window A at each
  // step; NEGMASS where there is no window below
  float amul[5];
  {
    float Ac = AF;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float Ap = __shfl_up_sync(FULL_MASK, Ac, 1 << k);
      const bool has = lane >= (1 << k);
      amul[k] = has ? Ac : NEGMASS;
      if (has) Ac = Ap + Ac;
    }
  }

  float m[SP], iv[SP], d[SP];
#pragma unroll
  for (int jj = 0; jj < SP; ++jj) m[jj] = iv[jj] = d[jj] = NEGMASS;
  float xN = 0.f, xB = move, xJ = NEGMASS, xC = NEGMASS;
  // the block route's carry: the previous row's slot below this thread
  float cm = NEGMASS, ci = NEGMASS, cd = NEGMASS;
  int par = 0;

  const uint8_t* seq = codes + (size_t)row * Lmax;
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int nr = min(32, L - i0);
    const int mycode = lane < nr ? (int)seq[i0 + lane] : 0;
    float2 ec[SP];
    if constexpr (PREFETCH) load_emis(__shfl_sync(FULL_MASK, mycode, 0), ec);
    // two rows an iteration, so the prefetch buffers swap by renaming
#pragma unroll(SP <= 8 ? 2 : 1)
    for (int r = 0; r < nr; ++r) {
      // the next row's emissions, off this row's dependency chain (the
      // last row of a block loads one it does not use)
      float2 en[PREFETCH ? SP : 1];
      if constexpr (PREFETCH)
        load_emis(__shfl_sync(FULL_MASK, mycode, (r + 1) & 31), en);
      else
        load_emis(__shfl_sync(FULL_MASK, mycode, r), ec);
      // the previous row's slot below this thread's first (lane 0 gets
      // its own last one, and the model's first slot adds NEGMASS
      // transitions to it)
      float pm, pi, pd;
      if constexpr (NW == 1) {
        pm = __shfl_up_sync(FULL_MASK, m[SP - 1], 1);
        pi = __shfl_up_sync(FULL_MASK, iv[SP - 1], 1);
        pd = __shfl_up_sync(FULL_MASK, d[SP - 1], 1);
      } else {
        pm = cm;
        pi = ci;
        pd = cd;
      }
      // M and I from the previous row; D with NEGMASS entering the
      // thread's slots (dl); C, the slots' share of E
      float dl = NEGMASS, C = NEGMASS;
#pragma unroll
      for (int jj = 0; jj < SP; ++jj) {
        const float4 a = TA(jj), b = TB(jj);
        const float2 e = ec[jj];
        const float om = m[jj], oi = iv[jj], od = d[jj];
        // B->M last: xB arrives at the end of the previous row's chain
        const float nm =
            fmaxf(e.x + fmaxf(fmaxf(pm + a.x, pi + a.y), pd + a.z),
                  xB + (a.w + e.x));
        m[jj] = nm;
        iv[jj] = fmaxf(e.y + fmaxf(om + b.x, oi + b.y), NEGMASS);
        d[jj] = dl;
        C = fmaxf(C, nm);
        dl = fmaxf(nm + b.z, dl + b.w);
        pm = om;
        pi = oi;
        pd = od;
      }
      float B = dl;
      float Bown = NEGMASS, Bpred = NEGMASS, Bq = NEGMASS;
      float4 car = make_float4(NEGMASS, NEGMASS, NEGMASS, 0.f);
      if constexpr (NW > 1) {
        // compose this lane's column of warps: its whole map, and the
        // prefixes below this thread and below the thread under it
        sBC[par][wi][lane] = make_float2(B, C);
        sCar[par][wi][lane] = make_float4(m[SP - 1], iv[SP - 1], d[SP - 1],
                                          0.f);
        __syncthreads();
        float Br = NEGMASS, Cr = NEGMASS;
#pragma unroll
        for (int v = 0; v < NW; ++v) {
          if (v == wi - 1) Bpred = Br;
          if (v == wi) Bown = Br;
          if (v == NW - 1) Bq = Br;
          const float2 bc = sBC[par][v][lane];
          Cr = fmaxf(Cr, bc.y);
          Br = fmaxf(Br + sA[v][lane].x, bc.x);
        }
        B = Br;
        C = Cr;
        car = sCar[par][wi > 0 ? wi - 1 : NW - 1][wi > 0 ? lane
                                                         : max(lane - 1, 0)];
        par ^= 1;
      }
      // the lanes' maps, scanned: B and C in parallel each step
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float Bp = __shfl_up_sync(FULL_MASK, B, 1 << k);
        const float Cp = __shfl_up_sync(FULL_MASK, C, 1 << k);
        C = fmaxf(C, Cp);
        B = fmaxf(B, Bp + amul[k]);
      }
      float X = __shfl_up_sync(FULL_MASK, B, 1);  // D entering the lane
      if (lane == 0) X = NEGMASS;
      const float xe = __shfl_sync(FULL_MASK, C, 31);  // E of the row
      float dd = X;  // D entering this thread's slots
      if constexpr (NW > 1) {
        dd = fmaxf(X + Aown, Bown);
        // the next row's carry: the last slot of the thread below
        float xp;
        if (wi > 0) {
          xp = fmaxf(X + Apred, Bpred);
        } else {
          const float Xl = __shfl_up_sync(FULL_MASK, X, 1);
          const float Bql = __shfl_up_sync(FULL_MASK, Bq, 1);
          xp = fmaxf(Xl + Aq, Bql);
        }
        cm = car.x;
        ci = car.y;
        cd = fmaxf(car.z, xp + alpha_pred);
      }
      // the D row: the local chain or what enters, carried down
      if constexpr (PRE_REGS) {
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) d[jj] = fmaxf(d[jj], dd + pre[jj]);
      } else {
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) {
          d[jj] = fmaxf(d[jj], dd);
          dd += TB(jj).w;
        }
      }
      const float xe2 = xe + LOG_HALF;
      const float nJ = fmaxf(xJ + loop, xe2);
      const float nC = fmaxf(xC + loop, xe2);
      const float nN = xN + loop;
      xB = fmaxf(nN, nJ) + move;
      xJ = nJ;
      xC = nC;
      xN = nN;
      if constexpr (PREFETCH) {
#pragma unroll
        for (int jj = 0; jj < SP; ++jj) ec[jj] = en[jj];
      }
    }
  }
  if (threadIdx.x % (32 * NWS) == 0) out[pair_out[w]] = xC + move;
}

// The wide route (models over 4,096 slots; the design in common.cuh): one
// CTA of NT threads a pair, thread t the run of SPT slots t*SPT ..
// t*SPT+SPT-1, its M, I and D in registers (SPT > 0, the ladder
// PYHMMER_CTA_REGS) or in a row of shared or global memory (SPT = 0, the
// run length a.spt).  A thread runs
// M and I over its slots and the D chain with NEGMASS entering (its map
// max(x + A, B), A the D->D sum over its slots; its E share the largest M
// cell), and cta_scan composes the maps, giving E and the D entering each
// thread.  The cells hold each slot's M, I and local D; the true D,
// max(local, X + the D->D sum to the slot), is formed when the next row
// reads it.  Cells are clamped at NEGMASS as in the plain version.
template <int NT, int SPT>
__global__ void __launch_bounds__(NT, 1)
vit_cta_kernel(const CtaArgs a, float* __restrict__ scratch) {
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
    const float loop = a.lm[row * 4 + 2], move = a.lm[row * 4 + 3];
    const float4* TR = a.trans + (size_t)p * n * 2 * NT + t;
    const float2* EM = a.emis + (size_t)p * a.Kp * n * NT + t;
    // the D->D sum over this thread's slots but the last (for the thread
    // above), and the thread below's (lane 0)
    float own_pre_last;
    const float nb_pre =
        cta_pre_last<MaxPlusMaps, NT>(TR, n, sPre, &own_pre_last);
#pragma unroll
    for (int j = 0; j < n; ++j)
      cell.at(0, j) = cell.at(1, j) = cell.at(2, j) = NEGMASS;
    float xN = 0.f, xB = move, xJ = NEGMASS, xC = NEGMASS;
    // the previous row's cells of slot t*SPT - 1 (true values), and the D
    // that entered this thread's slots on the previous row
    float cm = NEGMASS, ci = NEGMASS, cd = NEGMASS, Xprev = NEGMASS;
    int par = 0;
    const uint8_t* seq = a.codes + (size_t)row * a.Lmax;
    for (int i = 0; i < L; ++i) {
      const float2* em = EM + (size_t)__ldg(seq + i) * n * NT;
      float pm = cm, pi = ci, pd = cd;
      float dl = NEGMASS, C = NEGMASS, pre = 0.f;
      float lm_ = NEGMASS, li_ = NEGMASS, ld_ = NEGMASS;
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const float4 ta = __ldg(TR + (size_t)(2 * j) * NT);
        const float4 tb = __ldg(TR + (size_t)(2 * j + 1) * NT);
        const float2 e = __ldg(em + (size_t)j * NT);
        const float om = cell.at(0, j), oi = cell.at(1, j);
        const float od = fmaxf(fmaxf(cell.at(2, j), Xprev + pre), NEGMASS);
        const float nm = fmaxf(
            fmaxf(e.x + fmaxf(fmaxf(pm + ta.x, pi + ta.y), pd + ta.z),
                  xB + (ta.w + e.x)),
            NEGMASS);
        const float ni = fmaxf(e.y + fmaxf(om + tb.x, oi + tb.y), NEGMASS);
        cell.at(0, j) = nm;
        cell.at(1, j) = ni;
        cell.at(2, j) = dl;
        lm_ = nm;
        li_ = ni;
        ld_ = dl;
        C = fmaxf(C, nm);
        dl = fmaxf(nm + tb.z, dl + tb.w);
        pre += tb.w;
        pm = om;
        pi = oi;
        pd = od;
      }
      const CtaRow r = cta_scan<MaxPlusMaps, NT / 32>(
          pre, dl, C, 0.f, make_float4(lm_, li_, ld_, 0.f), sW[par],
          s30[par], sLast[par]);
      // this row's cells of slot t*SPT - 1: the thread below's last slot,
      // by shuffle, or for lane 0 from lane 31's copy
      cm = __shfl_up_sync(FULL_MASK, lm_, 1);
      ci = __shfl_up_sync(FULL_MASK, li_, 1);
      cd = __shfl_up_sync(
          FULL_MASK, fmaxf(fmaxf(ld_, r.Xt + own_pre_last), NEGMASS), 1);
      if (lane == 0) {
        if (wid > 0) {
          const float4 q = sLast[par][wid - 1];
          cm = q.x;
          ci = q.y;
          cd = fmaxf(fmaxf(q.z, r.Xnb + nb_pre), NEGMASS);
        } else {
          cm = ci = cd = NEGMASS;
        }
      }
      Xprev = r.Xt;
      const float xe2 = r.E + LOG_HALF;
      const float nJ = fmaxf(xJ + loop, xe2);
      const float nC = fmaxf(xC + loop, xe2);
      const float nN = xN + loop;
      xB = fmaxf(nN, nJ) + move;
      xJ = nJ;
      xC = nC;
      xN = nN;
      par ^= 1;
    }
    if (t == 0) a.out[a.pair_out[w]] = xC + move;
  }
}

// The block route's resident pairs on this card: blocks a SM (at the
// kernel's registers and shared memory) times the SMs.
template <int S>
static int block_capacity() {
  static int cap = -1;
  if (cap < 0) {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, vit_kernel<S, vit_warps(S, 8), true>, 32 * vit_warps(S, 8),
        0);
    cap = blocks * sms;
  }
  return cap;
}

// route: 1 one warp a pair (S <= 24), 2 the block route (S >=
// VIT_WIDE_S), 0 the default: one warp a pair below VIT_WIDE_S slots a
// lane, the block route from 32; at 16 and 24 the block route while the
// launch's pairs all fit on the card at once, one warp a pair beyond
// that (there the card is full either way, and the block route's
// barriers and shared-memory traffic cost more than they save).  The
// routes add the D->D sums in another order, so at 16 and 24 slots a
// lane a pair's score may move by a few ulps with the launch's size.
template <int S>
static int launch_vit(const void* codes, int Lmax, const void* lens,
                      const void* lm, const void* emis, const void* trans,
                      const void* pair_p, const void* pair_row,
                      const void* pair_out, int npairs, int Kp, int route,
                      void* out, cudaStream_t stream) {
  constexpr bool WIDE = S >= VIT_WIDE_S;
  if (route == 0) {
    if constexpr (S < VIT_WIDE_S) route = 1;
    else if constexpr (S > 24) route = 2;
    else route = npairs <= block_capacity<S>() ? 2 : 1;
  }
#define VIT_ARGS                                                         \
  (const uint8_t*)codes, Lmax, (const int*)lens, (const float*)lm,       \
      (const float*)emis, (const float*)trans, (const int*)pair_p,       \
      (const int*)pair_row, (const int*)pair_out, npairs, Kp, (float*)out
  if (route == 1) {
    if constexpr (S > 24) return (int)cudaErrorInvalidValue;
    else
      vit_kernel<S, 1, WIDE>
          <<<(npairs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
             32 * WARPS_PER_BLOCK, 0, stream>>>(VIT_ARGS);
  } else if (route == 2) {
    if constexpr (!WIDE) return (int)cudaErrorInvalidValue;
    else
      vit_kernel<S, vit_warps(S, 8), true>
          <<<npairs, 32 * vit_warps(S, 8), 0, stream>>>(VIT_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef VIT_ARGS
  return (int)cudaGetLastError();
}

extern "C" int vit_launch(const void* codes, int Lmax, const void* lens,
                          const void* lm, const void* emis,
                          const void* trans, const void* pair_p,
                          const void* pair_row, const void* pair_out,
                          int npairs, int Kp, int S, int route, void* out,
                          void* stream) {
  if (npairs <= 0) return 0;
  if (S == 0) return (int)cudaErrorInvalidValue;  // vit_cta_launch
  switch (S) {
#define PYHMMER_CASE(s)                                                   \
  case s:                                                                 \
    return launch_vit<s>(codes, Lmax, lens, lm, emis, trans, pair_p,      \
                         pair_row, pair_out, npairs, Kp, route, out,      \
                         (cudaStream_t)stream);
    PYHMMER_STRIPES(PYHMMER_CASE)
#undef PYHMMER_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wide route: the row in registers for the run lengths of the ladder,
// else in shared memory up to CTA_SMEM_SLOTS slots, else in scratch (3 *
// Mk floats for each of nctas CTAs; NULL is refused there).
extern "C" int vit_cta_launch(const void* codes, int Lmax, const void* lens,
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
    return cta_launch(vit_cta_kernel<t, s>, t, a, nullptr, 0, nctas, st);
  PYHMMER_CTA_REGS(PYHMMER_CASE)
#undef PYHMMER_CASE
  if (nt != CTA_THREADS) return (int)cudaErrorInvalidValue;
  if (Mk <= CTA_SMEM_SLOTS)
    return cta_launch(vit_cta_kernel<CTA_THREADS, 0>, nt, a, nullptr,
                      3 * Mk * (int)sizeof(float), nctas, st);
  if (!scratch) return (int)cudaErrorInvalidValue;
  return cta_launch(vit_cta_kernel<CTA_THREADS, 0>, nt, a,
                    (float*)scratch, 0, nctas, st);
}
