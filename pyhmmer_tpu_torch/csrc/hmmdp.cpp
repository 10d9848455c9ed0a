// Native host DP kernels for the Plan7 pipeline.
//
// Like the reference's striped SIMD implementations, Forward/Backward run
// in *odds space* (probabilities relative to background) with sparse
// rescaling -- multiply/add only, no per-cell transcendentals -- and the
// results are converted back to log space on output.  Agreement with the
// float64 log-space NumPy oracle is at the 1e-9 nat level (rescale
// rounding), far inside the reported-score tolerance.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <atomic>
#include <algorithm>
#include <type_traits>

namespace {

constexpr double NEGMASS = -1e30;
constexpr double RESCALE_HI = 1e250;
constexpr double TINY = 1e-290;

// The row-DP scalar type.  The parser/rescore/decode paths run in
// float32 -- the same precision class as the reference's striped SSE
// kernels (impl_sse/fwdback.c uses f32 + the FLogsum table; our f32 is
// strictly more accurate) -- with per-row max rescaling keeping raw odds
// in [0, 1] and all log-scale accumulation in float64.  The legacy
// log-space keep==0/1 entry points stay float64 (templated).
template <typename T> struct row_tiny;
template <> struct row_tiny<double> { static constexpr double v = 1e-290; };
template <> struct row_tiny<float>  { static constexpr float  v = 1e-30f; };

inline double xexp(double a) { return a <= -5e29 ? 0.0 : std::exp(a); }

inline double xlog(double a, double sc) {
    return a > 0.0 ? std::log(a) + sc : NEGMASS;
}

// One precision's view of the odds tables.
template <typename T>
struct Tables {
    T *eBM, *eMM, *eIM, *eDM, *eMD, *eDD, *eMI, *eII;
    T *eDD2, *eDD4;        // 2- and 4-step DD chain products (fwd)
    T *eDD2r, *eDD4r;      // reverse-chain products (backward)
    T *ems, *eis;          // [Kp * (M+1)] odds

    void alloc(int M, int W, int Kp) {
        eBM = new T[M]; eMM = new T[M]; eIM = new T[M];
        eDM = new T[M]; eMD = new T[M]; eDD = new T[M];
        eMI = new T[W]; eII = new T[W];
        ems = new T[(size_t)Kp * W]; eis = new T[(size_t)Kp * W];
        eDD2 = new T[W](); eDD4 = new T[W]();
        eDD2r = new T[W](); eDD4r = new T[W]();
    }
    void free() {
        delete[] eBM; delete[] eMM; delete[] eIM; delete[] eDM;
        delete[] eMD; delete[] eDD; delete[] eMI; delete[] eII;
        delete[] eDD2; delete[] eDD4;
        delete[] eDD2r; delete[] eDD4r;
        delete[] ems; delete[] eis;
    }
};

// Length-independent odds tables for one profile.  Building these costs
// ~10k exp() calls; a handle is exposed through the C ABI so Python can
// build them ONCE per profile (ops/native.py prewarm) instead of paying
// per domaindef/forward call.  Both float64 and float32 mirrors are
// kept: the hot domaindef paths run f32 rows, the legacy log-space
// entry points f64.
struct ExpCore {
    Tables<double> td;
    Tables<float> tf;
    int M, Kp;

    template <typename T> const Tables<T>& tables() const;

    ExpCore(const double* tBM, const double* tMM, const double* tIM,
            const double* tDM, const double* tMD, const double* tDD,
            const double* tMI, const double* tII,
            const double* msc, const double* isc,
            int M_, int Kp_) : M(M_), Kp(Kp_) {
        int W = M + 1;
        td.alloc(M, W, Kp);
        tf.alloc(M, W, Kp);
        for (int k = 0; k < M; k++) {
            td.eBM[k] = xexp(tBM[k]); td.eMM[k] = xexp(tMM[k]);
            td.eIM[k] = xexp(tIM[k]); td.eDM[k] = xexp(tDM[k]);
            td.eMD[k] = xexp(tMD[k]); td.eDD[k] = xexp(tDD[k]);
        }
        for (int k = 0; k < W; k++) {
            td.eMI[k] = xexp(tMI[k]); td.eII[k] = xexp(tII[k]);
        }
        for (size_t i = 0; i < (size_t)Kp * W; i++) {
            td.ems[i] = xexp(msc[i]); td.eis[i] = xexp(isc[i]);
        }
        for (int k = 2; k <= M; k++) {
            // forward chain-step products ENDING at nd[k]: d[k] = eDD[k-1]
            td.eDD2[k] = (k >= 2) ? td.eDD[k - 1] * td.eDD[k - 2] : 0.0;
            td.eDD4[k] = (k >= 4)
                ? td.eDD[k - 1] * td.eDD[k - 2] * td.eDD[k - 3]
                  * td.eDD[k - 4] : 0.0;
        }
        for (int k = 1; k <= M; k++) {
            // backward chain-step products: step into nd[k] is eDD[k]
            td.eDD2r[k] = (k + 1 <= M - 1) ? td.eDD[k] * td.eDD[k + 1] : 0.0;
            td.eDD4r[k] = (k + 3 <= M - 1)
                ? td.eDD[k] * td.eDD[k + 1] * td.eDD[k + 2]
                  * td.eDD[k + 3] : 0.0;
        }
        // float mirrors (rounded from the f64 tables)
        for (int k = 0; k < M; k++) {
            tf.eBM[k] = (float)td.eBM[k]; tf.eMM[k] = (float)td.eMM[k];
            tf.eIM[k] = (float)td.eIM[k]; tf.eDM[k] = (float)td.eDM[k];
            tf.eMD[k] = (float)td.eMD[k]; tf.eDD[k] = (float)td.eDD[k];
        }
        for (int k = 0; k < W; k++) {
            tf.eMI[k] = (float)td.eMI[k]; tf.eII[k] = (float)td.eII[k];
            tf.eDD2[k] = (float)td.eDD2[k]; tf.eDD4[k] = (float)td.eDD4[k];
            tf.eDD2r[k] = (float)td.eDD2r[k];
            tf.eDD4r[k] = (float)td.eDD4r[k];
        }
        for (size_t i = 0; i < (size_t)Kp * W; i++) {
            tf.ems[i] = (float)td.ems[i]; tf.eis[i] = (float)td.eis[i];
        }
    }
    ~ExpCore() { td.free(); tf.free(); }
};

template <> inline const Tables<double>& ExpCore::tables<double>() const {
    return td;
}
template <> inline const Tables<float>& ExpCore::tables<float>() const {
    return tf;
}

struct ExpProf {
    const ExpCore* core;
    // f64 aliases for the scalar/sampling code paths
    const double *eBM, *eMM, *eIM, *eDM, *eMD, *eDD, *eMI, *eII;
    double eE[2], eN[2], eJ[2], eC[2];
    int M, Kp;
    ExpCore* owned = nullptr;

    ExpProf(const double* tBM, const double* tMM, const double* tIM,
            const double* tDM, const double* tMD, const double* tDD,
            const double* tMI, const double* tII,
            const double* msc, const double* isc,
            const double* xE, const double* xN, const double* xJ,
            const double* xC, int M_, int Kp_,
            const ExpCore* core_ = nullptr) : M(M_), Kp(Kp_) {
        if (core_ == nullptr) {
            owned = new ExpCore(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII,
                                msc, isc, M_, Kp_);
            core_ = owned;
        }
        core = core_;
        eBM = core->td.eBM; eMM = core->td.eMM; eIM = core->td.eIM;
        eDM = core->td.eDM; eMD = core->td.eMD; eDD = core->td.eDD;
        eMI = core->td.eMI; eII = core->td.eII;
        for (int j = 0; j < 2; j++) {
            eE[j] = xexp(xE[j]); eN[j] = xexp(xN[j]);
            eJ[j] = xexp(xJ[j]); eC[j] = xexp(xC[j]);
        }
    }
    ~ExpProf() { delete owned; }
};

// Chunked thread-local bump allocator for the DP scratch: repeated
// MB-sized new/delete churns mmap'd pages (fresh page faults every call
// on glibc), which dominated domaindef wall time.  Chunks never move, so
// pointers stay valid until release(mark).
struct Arena {
    struct Chunk { char* p; size_t cap; };
    static constexpr size_t MIN_CHUNK = 1 << 21;     // bytes (2 MB)
    Chunk* chunks = nullptr;
    int nchunks = 0, capchunks = 0;
    int ci = 0;
    size_t used = 0;

    struct Mark { int ci; size_t used; };
    Mark mark() const { return {ci, used}; }
    void release(Mark m) { ci = m.ci; used = m.used; }

    char* alloc_bytes(size_t n) {
        n = (n + 63) & ~size_t(63);     // keep rows 64-byte aligned
        while (true) {
            if (ci < nchunks && used + n <= chunks[ci].cap) {
                char* p = chunks[ci].p + used;
                used += n;
                return p;
            }
            if (ci + 1 < nchunks) { ci++; used = 0; continue; }
            if (nchunks == capchunks) {
                int nc = capchunks ? capchunks * 2 : 8;
                Chunk* nb = new Chunk[nc];
                for (int i = 0; i < nchunks; i++) nb[i] = chunks[i];
                delete[] chunks;
                chunks = nb; capchunks = nc;
            }
            size_t cap = std::max(MIN_CHUNK, n);
            chunks[nchunks].p = static_cast<char*>(
                ::operator new(cap, std::align_val_t(64)));
            chunks[nchunks].cap = cap;
            if (nchunks > 0) { ci = nchunks; used = 0; }
            nchunks++;
        }
    }
    template <typename T = double>
    T* alloc(size_t n) {
        return reinterpret_cast<T*>(alloc_bytes(n * sizeof(T)));
    }
    template <typename T = double>
    T* zalloc(size_t n) {
        T* p = alloc<T>(n);
        std::memset(p, 0, n * sizeof(T));
        return p;
    }
};

thread_local Arena g_arena;

}  // namespace

namespace {


// Per-row Forward/Backward kernels extracted into noinline functions so
// the __restrict__ guarantees survive the row-buffer pointer swaps at the
// call site (gcc refuses to vectorize loops whose restrict pointers are
// std::swap'd in the enclosing scope).
template <typename T>
__attribute__((noinline))
static double fwd_row_core(
    int M,
    const T* __restrict__ ms, const T* __restrict__ is,
    const T* __restrict__ eMM, const T* __restrict__ eIM,
    const T* __restrict__ eDM, const T* __restrict__ eBM,
    const T* __restrict__ eMI, const T* __restrict__ eII,
    const T* __restrict__ eMD, const T* __restrict__ eDD,
    const T* __restrict__ eDD2, const T* __restrict__ eDD4,
    const T* __restrict__ mrow, const T* __restrict__ irow,
    const T* __restrict__ drow, T bprev,
    T* __restrict__ nm, T* __restrict__ ni,
    T* __restrict__ nd) {
    nm[0] = 0.0; ni[0] = 0.0; nd[0] = 0.0;
    for (int k = 1; k <= M; k++) {
        nm[k] = ms[k] * (mrow[k - 1] * eMM[k - 1]
                         + irow[k - 1] * eIM[k - 1]
                         + drow[k - 1] * eDM[k - 1]
                         + bprev * eBM[k - 1]);
    }
    for (int k = 1; k < M; k++)
        ni[k] = is[k] * (mrow[k] * eMI[k] + irow[k] * eII[k]);
    for (int k = std::max(M, 1); k <= M; k++) ni[k] = 0.0;
    if (M >= 1) nd[1] = 0.0;
    if (M <= 8) {
        for (int k = 2; k <= M; k++)
            nd[k] = nm[k - 1] * eMD[k - 1] + nd[k - 1] * eDD[k - 1];
    } else {
        // 4-way unrolled first-order chain: two vector doubling passes,
        // then a serial pass with dependency distance 4 (the sequential
        // FMA chain's ~4.5-cycle latency otherwise dominates the row).
        // a[k] = nm[k-1]*eMD[k-1]; chain step into nd[k] is eDD[k-1]
        for (int k = 2; k <= M; k++) nd[k] = nm[k - 1] * eMD[k - 1];
        // pass 1 (desc): b[k] = a[k] + a[k-1]*d[k]
        for (int k = M; k >= 3; k--)
            nd[k] += nd[k - 1] * eDD[k - 1];
        // pass 2 (desc): c[k] = b[k] + b[k-2]*d2[k]
        for (int k = M; k >= 4; k--)
            nd[k] += nd[k - 2] * eDD2[k];
        // serial (asc): nd[k] = c[k] + nd[k-4]*d4[k] -- 4 interleaved
        // chains the CPU pipelines concurrently
        for (int k = 5; k <= M; k++)
            nd[k] += nd[k - 4] * eDD4[k];
    }
    T em = (T)0.0, ed = (T)0.0;
    for (int k = 1; k <= M; k++) em += nm[k];
    for (int k = 1; k <= M; k++) ed += nd[k];
    return (double)em + (double)ed;
}

template <typename T>
__attribute__((noinline))
static double bck_b_core(
    int M, const T* __restrict__ ms,
    const T* __restrict__ eBM, const T* __restrict__ mrow) {
    T b = (T)0.0;
    for (int k = 1; k <= M; k++)
        b += mrow[k] * eBM[k - 1] * ms[k];
    return (double)b;
}

template <typename T>
__attribute__((noinline))
static void bck_row_core(
    int M,
    const T* __restrict__ ms, const T* __restrict__ is,
    const T* __restrict__ eMM, const T* __restrict__ eIM,
    const T* __restrict__ eDM,
    const T* __restrict__ eMI, const T* __restrict__ eII,
    const T* __restrict__ eMD, const T* __restrict__ eDD,
    const T* __restrict__ eDD2r, const T* __restrict__ eDD4r,
    const T* __restrict__ mrow, const T* __restrict__ irow,
    T e_,
    T* __restrict__ nm, T* __restrict__ ni,
    T* __restrict__ nd) {
    ni[0] = 0.0;
    for (int k = 1; k < M; k++)
        ni[k] = mrow[k + 1] * eIM[k] * ms[k + 1]
                + irow[k] * eII[k] * is[k];
    for (int k = std::max(M, 1); k <= M; k++) ni[k] = 0.0;
    nd[0] = 0.0;
    if (M >= 1) nd[M] = e_;
    if (M <= 8) {
        for (int k = M - 1; k >= 1; k--)
            nd[k] = e_ + mrow[k + 1] * eDM[k] * ms[k + 1]
                    + nd[k + 1] * eDD[k];
    } else {
        // 4-way unrolled reverse chain (see fwd_row_core)
        for (int k = M - 1; k >= 1; k--)
            nd[k] = e_ + mrow[k + 1] * eDM[k] * ms[k + 1];
        for (int k = 1; k <= M - 1; k++)
            nd[k] += nd[k + 1] * eDD[k];
        for (int k = 1; k <= M - 2; k++)
            nd[k] += nd[k + 2] * eDD2r[k];
        for (int k = M - 4; k >= 1; k--)
            nd[k] += nd[k + 4] * eDD4r[k];
    }
    nm[0] = 0.0;
    for (int k = 1; k <= M; k++) nm[k] = e_;
    for (int k = 1; k < M; k++)
        nm[k] += mrow[k + 1] * eMM[k] * ms[k + 1]
                 + irow[k] * eMI[k] * is[k]
                 + nd[k + 1] * eMD[k];
}

template <typename T>
__attribute__((noinline))
static void scale_store_row(
    int W, T inv,
    T* __restrict__ mrow, T* __restrict__ irow,
    T* __restrict__ drow,
    T* __restrict__ Mo, T* __restrict__ Io,
    T* __restrict__ Do) {
    Mo[0] = Io[0] = Do[0] = 0.0;
    for (int k = 1; k < W; k++) {
        mrow[k] *= inv; irow[k] *= inv; drow[k] *= inv;
        Mo[k] = mrow[k]; Io[k] = irow[k]; Do[k] = drow[k];
    }
}

template <typename T>
double fwd_impl(
    const ExpProf& P, const uint8_t* dsq, int32_t L,
    const double* xN, int32_t M, int32_t Kp,
    double* xNv, double* xBv, double* xEv, double* xCv, double* xJv,
    T* Mm, T* Im, T* Dm, int32_t keep, double* rowscale) {
    const int W = M + 1;
    const Tables<T>& tb = P.core->template tables<T>();
    Arena::Mark amark = g_arena.mark();
    T* __restrict__ mrow = g_arena.zalloc<T>(W);
    T* __restrict__ irow = g_arena.zalloc<T>(W);
    T* __restrict__ drow = g_arena.zalloc<T>(W);
    T* __restrict__ nm = g_arena.zalloc<T>(W);
    T* __restrict__ ni = g_arena.zalloc<T>(W);
    T* __restrict__ nd = g_arena.zalloc<T>(W);

    // N is a pure product chain (never receives summed mass in Forward),
    // so it is tracked in log space to stay exact across rescales
    double logN = 0.0;
    double b_ = P.eN[1], j_ = 0.0, c_ = 0.0;   // linear specials
    double logscale = 0.0;
    const bool lin_spec = (keep == 3 || keep == 4);   // linear specials
    const bool raw_mx = (keep == 2 || keep == 4);     // raw odds matrices
    if (lin_spec) {
        xNv[0] = 1.0; xBv[0] = b_;
        xEv[0] = xCv[0] = xJv[0] = 0.0;
        rowscale[0] = 0.0;
    } else {
        xNv[0] = 0.0; xBv[0] = std::log(b_);
        xEv[0] = xCv[0] = xJv[0] = NEGMASS;
    }
    if (keep == 1)
        for (int k = 0; k < W; k++) Mm[k] = Im[k] = Dm[k] = (T)NEGMASS;
    if (raw_mx) {
        for (int k = 0; k < W; k++) Mm[k] = Im[k] = Dm[k] = (T)0.0;
        rowscale[0] = 0.0;
    }

    for (int i = 1; i <= L; i++) {
        const T* ms = tb.ems + (size_t)dsq[i - 1] * W;
        const T* is = tb.eis + (size_t)dsq[i - 1] * W;
        double e = fwd_row_core<T>(M, ms, is, tb.eMM, tb.eIM, tb.eDM,
                                   tb.eBM, tb.eMI, tb.eII, tb.eMD, tb.eDD,
                                   tb.eDD2, tb.eDD4,
                                   mrow, irow, drow, (T)b_, nm, ni, nd);
        j_ = j_ * P.eJ[0] + e * P.eE[0];
        c_ = c_ * P.eC[0] + e * P.eE[1];
        logN += xN[0];
        double n_scaled = std::exp(logN - logscale);
        b_ = n_scaled * P.eN[1] + j_ * P.eJ[1];
        if (!lin_spec) {
            xEv[i] = xlog(e, logscale);
            xJv[i] = xlog(j_, logscale);
            xCv[i] = xlog(c_, logscale);
            xNv[i] = logN;
            xBv[i] = xlog(b_, logscale);
        }
        std::swap(mrow, nm); std::swap(irow, ni); std::swap(drow, nd);
        if (keep == 1) {
            T* Mo = Mm + (size_t)i * W;
            T* Io = Im + (size_t)i * W;
            T* Do = Dm + (size_t)i * W;
            Mo[0] = Io[0] = Do[0] = (T)NEGMASS;
            for (int k = 1; k < W; k++) {
                Mo[k] = (T)xlog(mrow[k], logscale);
                Io[k] = (T)xlog(irow[k], logscale);
                Do[k] = (T)xlog(drow[k], logscale);
            }
        }
        if (raw_mx || keep == 3) {
            // odds mode: rescale by the row max so stored raw values
            // stay bounded, then store raw odds + the row's log scale.
            // The rescale runs every SECOND row (and the last): one
            // row's growth is bounded by ~4x the max emission odds, far
            // inside f32 range, and the per-row ``rowscale`` bookkeeping
            // stays exact either way -- this halves the max-pass +
            // 3-array scale + log() cost of the parsers.  keep==3 keeps
            // only the linear specials (domaindef region finding).
            double inv = 1.0;
            if ((i & 1) == 0 || i == L) {
                T mxr = row_tiny<T>::v;
                for (int k = 1; k < W; k++) mxr = std::max(mxr, mrow[k]);
                double mx = std::max((double)mxr, std::max(j_, c_));
                inv = 1.0 / mx;
                if (!raw_mx) {
                    const T invT = (T)inv;
                    for (int k = 0; k < W; k++) {
                        mrow[k] *= invT; irow[k] *= invT; drow[k] *= invT;
                    }
                }
                logscale += std::log(mx);
            }
            if (raw_mx)
                scale_store_row<T>(W, (T)inv, mrow, irow, drow,
                                   Mm + (size_t)i * W, Im + (size_t)i * W,
                                   Dm + (size_t)i * W);
            b_ *= inv; j_ *= inv; c_ *= inv;
            rowscale[i] = logscale;
            if (lin_spec) {
                double ns = n_scaled * inv;
                xEv[i] = e * inv;
                xJv[i] = j_;
                xCv[i] = c_;
                xNv[i] = ns;
                xBv[i] = b_;
            }
        } else if (e > RESCALE_HI || (e > 0 && e < 1.0 / RESCALE_HI)) {
            double s = e;
            const T invT = (T)(1.0 / s);
            for (int k = 0; k < W; k++) {
                mrow[k] *= invT; irow[k] *= invT; drow[k] *= invT;
            }
            b_ *= 1.0 / s; j_ *= 1.0 / s; c_ *= 1.0 / s;
            logscale += std::log(s);
        }
    }
    double score = xlog(c_, logscale)
                   + (P.eC[1] > 0.0 ? std::log(P.eC[1]) : NEGMASS);
    g_arena.release(amark);
    return score;
}

template <typename T>
double bck_impl(
    const ExpProf& P, const uint8_t* dsq, int32_t L,
    int32_t M, int32_t Kp,
    double* xNv, double* xBv, double* xEv, double* xCv, double* xJv,
    T* Mm, T* Im, T* Dm, int32_t keep, double* rowscale) {
    const int W = M + 1;
    const Tables<T>& tb = P.core->template tables<T>();
    Arena::Mark amark = g_arena.mark();
    T* __restrict__ mrow = g_arena.zalloc<T>(W);
    T* __restrict__ irow = g_arena.zalloc<T>(W);
    T* __restrict__ drow = g_arena.zalloc<T>(W);
    T* __restrict__ nm = g_arena.zalloc<T>(W);
    T* __restrict__ ni = g_arena.zalloc<T>(W);
    T* __restrict__ nd = g_arena.zalloc<T>(W);

    double logscale = 0.0;
    double c_ = P.eC[1];
    double e_ = c_ * P.eE[1];
    double n_ = 0.0, b_ = 0.0, j_ = 0.0;
    const bool lin_spec = (keep == 3 || keep == 4);
    const bool raw_mx = (keep == 2 || keep == 4);
    if (lin_spec) {
        xCv[L] = c_; xEv[L] = e_;
        xNv[L] = xBv[L] = xJv[L] = 0.0;
        rowscale[L] = 0.0;
    } else {
        xCv[L] = xlog(c_, 0.0);
        xEv[L] = xlog(e_, 0.0);
        xNv[L] = xBv[L] = xJv[L] = NEGMASS;
    }
    drow[0] = (T)0.0;
    if (M >= 1) drow[M] = (T)e_;
    for (int k = M - 1; k >= 1; k--)
        drow[k] = (T)e_ + drow[k + 1] * tb.eDD[k];
    mrow[0] = (T)0.0;
    for (int k = 1; k <= M; k++) mrow[k] = (T)e_;
    for (int k = 1; k < M; k++)
        mrow[k] += drow[k + 1] * tb.eMD[k];
    if (keep == 1) {
        T* Mo = Mm + (size_t)L * W;
        T* Io = Im + (size_t)L * W;
        T* Do = Dm + (size_t)L * W;
        Mo[0] = Io[0] = Do[0] = (T)NEGMASS;
        for (int k = 1; k < W; k++) {
            Mo[k] = (T)xlog(mrow[k], 0.0);
            Io[k] = (T)NEGMASS;
            Do[k] = (T)xlog(drow[k], 0.0);
        }
    }
    if (raw_mx) {
        T* Mo = Mm + (size_t)L * W;
        T* Io = Im + (size_t)L * W;
        T* Do = Dm + (size_t)L * W;
        Mo[0] = Io[0] = Do[0] = (T)0.0;
        for (int k = 1; k < W; k++) {
            Mo[k] = mrow[k]; Io[k] = (T)0.0; Do[k] = drow[k];
        }
        rowscale[L] = 0.0;
    }

    for (int i = L - 1; i >= 0; i--) {
        const T* ms = tb.ems + (size_t)dsq[i] * W;
        const T* is = tb.eis + (size_t)dsq[i] * W;
        double b = bck_b_core<T>(M, ms, tb.eBM, mrow);
        b_ = b;
        j_ = j_ * P.eJ[0] + b * P.eJ[1];
        c_ = c_ * P.eC[0];
        n_ = n_ * P.eN[0] + b * P.eN[1];
        e_ = j_ * P.eE[0] + c_ * P.eE[1];
        if (!lin_spec) {
            xBv[i] = xlog(b_, logscale);
            xJv[i] = xlog(j_, logscale);
            xCv[i] = xlog(c_, logscale);
            xNv[i] = xlog(n_, logscale);
            xEv[i] = xlog(e_, logscale);
        }

        bck_row_core<T>(M, ms, is, tb.eMM, tb.eIM, tb.eDM,
                        tb.eMI, tb.eII, tb.eMD, tb.eDD,
                        tb.eDD2r, tb.eDD4r,
                        mrow, irow, (T)e_, nm, ni, nd);
        std::swap(mrow, nm); std::swap(irow, ni); std::swap(drow, nd);
        if (keep == 1) {
            T* Mo = Mm + (size_t)i * W;
            T* Io = Im + (size_t)i * W;
            T* Do = Dm + (size_t)i * W;
            Mo[0] = Io[0] = Do[0] = (T)NEGMASS;
            for (int k = 1; k < W; k++) {
                Mo[k] = (T)xlog(mrow[k], logscale);
                Io[k] = (T)xlog(irow[k], logscale);
                Do[k] = (T)xlog(drow[k], logscale);
            }
        }
        if (raw_mx || keep == 3) {
            // every-2nd-row rescale, same argument as the forward parser
            double inv = 1.0;
            if ((i & 1) == 0 || i == 0) {
                T mxr = row_tiny<T>::v;
                for (int k = 1; k < W; k++) mxr = std::max(mxr, mrow[k]);
                double mx = (double)mxr;
                inv = 1.0 / mx;
                logscale += std::log(mx);
            }
            const T invT = (T)inv;
            if (raw_mx) {
                T* __restrict__ Mo = Mm + (size_t)i * W;
                T* __restrict__ Io = Im + (size_t)i * W;
                T* __restrict__ Do = Dm + (size_t)i * W;
                Mo[0] = Io[0] = Do[0] = (T)0.0;
#pragma GCC ivdep
                for (int k = 1; k < W; k++) {
                    mrow[k] *= invT; irow[k] *= invT; drow[k] *= invT;
                    Mo[k] = mrow[k]; Io[k] = irow[k]; Do[k] = drow[k];
                }
            } else if (inv != 1.0) {
                for (int k = 0; k < W; k++) {
                    mrow[k] *= invT; irow[k] *= invT; drow[k] *= invT;
                }
            }
            n_ *= inv; b_ *= inv; j_ *= inv; c_ *= inv; e_ *= inv;
            rowscale[i] = logscale;
            if (lin_spec) {
                xBv[i] = b_;
                xJv[i] = j_;
                xCv[i] = c_;
                xNv[i] = n_;
                xEv[i] = e_;
            }
        } else {
            T mxr = (T)0.0;
            for (int k = 1; k < W; k++) mxr = std::max(mxr, mrow[k]);
            double mx = (double)mxr;
            if (mx > RESCALE_HI || (mx > 0 && mx < 1.0 / RESCALE_HI)) {
                const T invT = (T)(1.0 / mx);
                for (int k = 0; k < W; k++) {
                    mrow[k] *= invT; irow[k] *= invT; drow[k] *= invT;
                }
                n_ *= 1.0 / mx; b_ *= 1.0 / mx; j_ *= 1.0 / mx;
                c_ *= 1.0 / mx; e_ *= 1.0 / mx;
                logscale += std::log(mx);
            }
        }
    }
    double score = xlog(n_, logscale);
    g_arena.release(amark);
    return score;
}

// Fused Backward + posterior decode for the envelope rescore (keep=4
// semantics).  Instead of storing the three backward matrices and
// multiplying them against the forward matrices in a separate pass, the
// posterior rows are emitted inside the backward scan -- ~1/3 of the
// envelope path's memory traffic.  Outputs match the unfused
// bck_impl(keep=4) + decode exactly (same operations, same order).
template <typename T>
static void bck_decode_impl(
    const ExpProf& P, const uint8_t* dsq, int32_t L,
    int32_t M, int32_t Kp,
    const T* __restrict__ fM, const T* __restrict__ fI,  // fwd raw odds
    const double* fxN, const double* fxJ, const double* fxC,  // fwd lin
    const double* fsc_row,                               // fwd row scales
    double envsc,
    T* __restrict__ ppM, T* __restrict__ ppI,            // [L+1, W] out
    T* ppN, T* ppJ, T* ppC) {                            // [L+1] out
    const int W = M + 1;
    const Tables<T>& tb = P.core->template tables<T>();
    Arena::Mark amark = g_arena.mark();
    T* __restrict__ mrow = g_arena.zalloc<T>(W);
    T* __restrict__ irow = g_arena.zalloc<T>(W);
    T* __restrict__ drow = g_arena.zalloc<T>(W);
    T* __restrict__ nm = g_arena.zalloc<T>(W);
    T* __restrict__ ni = g_arena.zalloc<T>(W);
    T* __restrict__ nd = g_arena.zalloc<T>(W);

    const double eLoop = P.eN[0];   // == eJ[0] == eC[0] (unihit config)
    double logscale = 0.0;
    double c_ = P.eC[1];
    double e_ = c_ * P.eE[1];
    double n_ = 0.0, b_ = 0.0, j_ = 0.0;
    drow[0] = (T)0.0;
    if (M >= 1) drow[M] = (T)e_;
    for (int k = M - 1; k >= 1; k--)
        drow[k] = (T)e_ + drow[k + 1] * tb.eDD[k];
    mrow[0] = (T)0.0;
    for (int k = 1; k <= M; k++) mrow[k] = (T)e_;
    for (int k = 1; k < M; k++)
        mrow[k] += drow[k + 1] * tb.eMD[k];

    // row L emissions (irow == 0 there; bck N/J specials are 0 at L)
    ppM[0] = ppI[0] = (T)0.0;
    for (int k = 0; k < W; k++) { ppM[k] = (T)0.0; ppI[k] = (T)0.0; }
    {
        double arg = fsc_row[L] - envsc;
        T rfac = (T)std::exp(std::min(arg, 80.0));
        T* __restrict__ pMo = ppM + (size_t)L * W;
        T* __restrict__ pIo = ppI + (size_t)L * W;
        const T* __restrict__ fMo = fM + (size_t)L * W;
        pMo[0] = pIo[0] = (T)0.0;
#pragma GCC ivdep
        for (int k = 1; k < W; k++) {
            pMo[k] = fMo[k] * mrow[k] * rfac;
            pIo[k] = (T)0.0;
        }
        ppN[0] = ppJ[0] = ppC[0] = (T)0.0;
        if (L >= 1) {
            double ef = std::exp(std::min(fsc_row[L - 1] - envsc, 80.0));
            ppN[L] = (T)0.0;
            ppJ[L] = (T)0.0;
            ppC[L] = (T)(fxC[L - 1] * eLoop * c_ * ef);
        }
    }

    for (int i = L - 1; i >= 0; i--) {
        const T* ms = tb.ems + (size_t)dsq[i] * W;
        const T* is = tb.eis + (size_t)dsq[i] * W;
        double b = bck_b_core<T>(M, ms, tb.eBM, mrow);
        b_ = b;
        j_ = j_ * P.eJ[0] + b * P.eJ[1];
        c_ = c_ * P.eC[0];
        n_ = n_ * P.eN[0] + b * P.eN[1];
        e_ = j_ * P.eE[0] + c_ * P.eE[1];
        bck_row_core<T>(M, ms, is, tb.eMM, tb.eIM, tb.eDM,
                        tb.eMI, tb.eII, tb.eMD, tb.eDD,
                        tb.eDD2r, tb.eDD4r,
                        mrow, irow, (T)e_, nm, ni, nd);
        std::swap(mrow, nm); std::swap(irow, ni); std::swap(drow, nd);
        double inv = 1.0;
        if ((i & 1) == 0 || i == 0) {
            T mxr = row_tiny<T>::v;
            for (int k = 1; k < W; k++) mxr = std::max(mxr, mrow[k]);
            double mx = (double)mxr;
            inv = 1.0 / mx;
            logscale += std::log(mx);
        }
        const T invT = (T)inv;
        if (inv != 1.0) {
            for (int k = 0; k < W; k++) {
                mrow[k] *= invT; irow[k] *= invT; drow[k] *= invT;
            }
        }
        n_ *= inv; b_ *= inv; j_ *= inv; c_ *= inv; e_ *= inv;
        if (i >= 1) {
            double arg = fsc_row[i] + logscale - envsc;
            T rfac = (T)std::exp(std::min(arg, 80.0));
            T* __restrict__ pMo = ppM + (size_t)i * W;
            T* __restrict__ pIo = ppI + (size_t)i * W;
            const T* __restrict__ fMo = fM + (size_t)i * W;
            const T* __restrict__ fIo = fI + (size_t)i * W;
            const T* __restrict__ mr = mrow;
            const T* __restrict__ ir = irow;
            pMo[0] = pIo[0] = (T)0.0;
#pragma GCC ivdep
            for (int k = 1; k < W; k++) {
                pMo[k] = fMo[k] * mr[k] * rfac;
                pIo[k] = fIo[k] * ir[k] * rfac;
            }
            double ef = std::exp(std::min(
                fsc_row[i - 1] + logscale - envsc, 80.0));
            ppN[i] = (T)(fxN[i - 1] * eLoop * n_ * ef);
            ppJ[i] = (T)(fxJ[i - 1] * eLoop * j_ * ef);
            ppC[i] = (T)(fxC[i - 1] * eLoop * c_ * ef);
        }
    }
    g_arena.release(amark);
}

template <typename T>
static double optacc_impl(
    const T* ppM, const T* ppI,             // [L+1, M+1]
    const T* ppN, const T* ppJ, const T* ppC,  // [L+1]
    const T* gMM, const T* gIM, const T* gDM,
    const T* gMD, const T* gDD,             // [M] gates (0 / NEGMASS)
    const T* gMI, const T* gII,             // [M+1]
    const T* gBM,                           // [M]
    int32_t eJ_ok, int32_t L, int32_t M,
    T* Mx, T* Ix, T* Dx,                    // [L+1, M+1]
    T* xN, T* xB, T* xE, T* xJ, T* xC) {
    const int W = M + 1;
    const T NEG = (T)NEGMASS;
    for (int k = 0; k < W; k++) Mx[k] = Ix[k] = Dx[k] = NEG;
    xN[0] = (T)0.0; xB[0] = (T)0.0;
    xE[0] = xJ[0] = xC[0] = NEG;
    // DD-chain doubling constants (max-plus is associative, so the
    // first-order chain dc[k] = max(a[k], dc[k-1]+d[k]) unrolls into two
    // vector passes + one serial pass of dependency distance 4, same
    // scheme as the forward parser's sum chain): d[k] = gDD[k-1]
    Arena::Mark oamark = g_arena.mark();
    T* __restrict__ d1 = g_arena.alloc<T>(W);
    T* __restrict__ d2 = g_arena.alloc<T>(W);
    T* __restrict__ d4 = g_arena.alloc<T>(W);
    for (int k = 0; k < W; k++) d1[k] = NEG;
    for (int k = 3; k <= M; k++) d1[k] = gDD[k - 1];
    for (int k = 0; k < W; k++) d2[k] = NEG;
    for (int k = 4; k <= M; k++) d2[k] = d1[k] + d1[k - 1];
    for (int k = 0; k < W; k++) d4[k] = NEG;
    for (int k = 6; k <= M; k++) d4[k] = d2[k] + d2[k - 2];
    for (int i = 1; i <= L; i++) {
        T* mc = Mx + (size_t)i * W;
        T* ic = Ix + (size_t)i * W;
        T* dc = Dx + (size_t)i * W;
        const T* mp = Mx + (size_t)(i - 1) * W;
        const T* ip = Ix + (size_t)(i - 1) * W;
        const T* dp = Dx + (size_t)(i - 1) * W;
        const T* pm = ppM + (size_t)i * W;
        const T* pi = ppI + (size_t)i * W;
        mc[0] = ic[0] = dc[0] = NEG;
        const T xbm1 = xB[i - 1];
#pragma GCC ivdep
        for (int k = 1; k <= M; k++) {
            T v = std::max(std::max(mp[k - 1] + gMM[k - 1],
                                    ip[k - 1] + gIM[k - 1]),
                           std::max(dp[k - 1] + gDM[k - 1],
                                    xbm1 + gBM[k - 1]));
            mc[k] = pm[k] + v;
        }
#pragma GCC ivdep
        for (int k = 1; k < M; k++)
            ic[k] = pi[k] + std::max(mp[k] + gMI[k], ip[k] + gII[k]);
        for (int k = std::max(M, 1); k < W; k++) ic[k] = NEG;
        if (M >= 1) dc[1] = NEG;
        if (M <= 8) {
            for (int k = 2; k <= M; k++)
                dc[k] = std::max(mc[k - 1] + gMD[k - 1],
                                 dc[k - 1] + gDD[k - 1]);
        } else {
            for (int k = 2; k <= M; k++) dc[k] = mc[k - 1] + gMD[k - 1];
            for (int k = M; k >= 3; k--)
                dc[k] = std::max(dc[k], dc[k - 1] + d1[k]);
            for (int k = M; k >= 4; k--)
                dc[k] = std::max(dc[k], dc[k - 2] + d2[k]);
            for (int k = 6; k <= M; k++)
                dc[k] = std::max(dc[k], dc[k - 4] + d4[k]);
        }
        T e = NEG;
        for (int k = 1; k <= M; k++) e = std::max(e, mc[k]);
        if (M >= 1) e = std::max(e, dc[M]);
        xE[i] = e;
        xJ[i] = std::max((T)(xJ[i - 1] + ppJ[i]), eJ_ok ? e : NEG);
        xC[i] = std::max((T)(xC[i - 1] + ppC[i]), e);
        xN[i] = xN[i - 1] + ppN[i];
        xB[i] = std::max(xN[i], xJ[i]);
    }
    g_arena.release(oamark);
    return (double)xC[L];
}

}  // namespace

extern "C" {

double hmmdp_forward(
    const uint8_t* dsq, int32_t L,
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc,
    const double* xE, const double* xN, const double* xJ, const double* xC,
    int32_t M, int32_t Kp,
    double* xNv, double* xBv, double* xEv, double* xCv, double* xJv,
    double* Mm, double* Im, double* Dm, int32_t keep, double* rowscale) {
    ExpProf P(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII, msc, isc,
              xE, xN, xJ, xC, M, Kp);
    return fwd_impl<double>(P, dsq, L, xN, M, Kp, xNv, xBv, xEv, xCv, xJv,
                            Mm, Im, Dm, keep, rowscale);
}

double hmmdp_backward(
    const uint8_t* dsq, int32_t L,
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc,
    const double* xE, const double* xN, const double* xJ, const double* xC,
    int32_t M, int32_t Kp,
    double* xNv, double* xBv, double* xEv, double* xCv, double* xJv,
    double* Mm, double* Im, double* Dm, int32_t keep, double* rowscale) {
    ExpProf P(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII, msc, isc,
              xE, xN, xJ, xC, M, Kp);
    return bck_impl<double>(P, dsq, L, M, Kp, xNv, xBv, xEv, xCv, xJv,
                            Mm, Im, Dm, keep, rowscale);
}

// Build / free a cached ExpCore (length-independent odds tables) for one
// profile.  Python keeps the handle alive for the profile's lifetime.
void* hmmdp_core_new(
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc, int32_t M, int32_t Kp) {
    return new ExpCore(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII,
                       msc, isc, M, Kp);
}

void hmmdp_core_free(void* core) {
    delete reinterpret_cast<ExpCore*>(core);
}

// Optimal accuracy DP (gated max-plus on posteriors; stays in log space --
// values are posterior sums, no transcendentals involved).
double hmmdp_optacc(
    const double* ppM, const double* ppI,   // [L+1, M+1]
    const double* ppN, const double* ppJ, const double* ppC,  // [L+1]
    const double* gMM, const double* gIM, const double* gDM,
    const double* gMD, const double* gDD,   // [M] gates (0 / NEGMASS)
    const double* gMI, const double* gII,   // [M+1]
    const double* gBM,                      // [M]
    int32_t eJ_ok, int32_t L, int32_t M,
    double* Mx, double* Ix, double* Dx,     // [L+1, M+1]
    double* xN, double* xB, double* xE, double* xJ, double* xC) {
    return optacc_impl<double>(ppM, ppI, ppN, ppJ, ppC,
                               gMM, gIM, gDM, gMD, gDD, gMI, gII, gBM,
                               eJ_ok, L, M, Mx, Ix, Dx, xN, xB, xE, xJ, xC);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Stochastic traceback ensemble (region resolution + trace null2)
// ---------------------------------------------------------------------------
//
// Samples N paths from a (log-space) Forward matrix of a region and
// returns the sampled domain spans plus the per-position trace null2
// accumulation (p7_Null2_ByTrace per sampled domain, summed over samples;
// the caller divides by N).

namespace {

struct Rng {  // xoshiro256** -- fast, good quality for sampling
    uint64_t s[4];
    explicit Rng(uint64_t seed) {
        uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
        for (int i = 0; i < 4; i++) {
            z ^= z >> 30; z *= 0xBF58476D1CE4E5B9ULL;
            z ^= z >> 27; z *= 0x94D049BB133111EBULL;
            z ^= z >> 31;
            s[i] = z + (z == 0);
            z += 0x9E3779B97F4A7C15ULL;
        }
    }
    static inline uint64_t rotl(uint64_t x, int k) {
        return (x << k) | (x >> (64 - k));
    }
    uint64_t next() {
        uint64_t result = rotl(s[1] * 5, 7) * 9;
        uint64_t t = s[1] << 17;
        s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
        s[2] ^= t; s[3] = rotl(s[3], 45);
        return result;
    }
    double uniform() {  // [0, 1)
        return (next() >> 11) * 0x1.0p-53;
    }
};

inline int choose(Rng& rng, const double* logp, int n) {
    // two-pass categorical draw (no scratch buffer; n can be M+1)
    double mx = NEGMASS;
    for (int i = 0; i < n; i++) mx = std::max(mx, logp[i]);
    if (mx <= -5e29) return 0;
    double tot = 0.0;
    for (int i = 0; i < n; i++) tot += std::exp(logp[i] - mx);
    double u = rng.uniform() * tot;
    for (int i = 0; i < n; i++) {
        u -= std::exp(logp[i] - mx);
        if (u <= 0) return i;
    }
    return n - 1;
}

}  // namespace

extern "C" {

// Returns the number of sampled spans written (up to max_spans).
// spans_out: per span [sample_idx, a, b] int32 triples.
// n2acc: [L+2] accumulated per-position null2 log-odds (caller /= N).
int32_t hmmdp_stotrace(
    const uint8_t* dsq, int32_t L,
    const double* Mm, const double* Im, const double* Dm,   // [L+1, W] log
    const double* xNv, const double* xBv, const double* xEv,
    const double* xCv, const double* xJv,                   // [L+1]
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* xE, const double* xN, const double* xJ, const double* xC,
    const double* odds_m, const double* odds_i,             // [K, W]
    int32_t M, int32_t K, int32_t nsamples, uint64_t seed,
    int32_t* spans_out, int32_t max_spans, double* n2acc) {
    const int W = M + 1;
    Rng rng(seed);
    double* uM = new double[W];
    double* uI = new double[W];
    double* lp = new double[W + 1];
    int nspans = 0;

    for (int s = 0; s < nsamples; s++) {
        int state = 0;  // 0=C 1=E 2=M 3=D 4=I 5=B 6=J 7=N
        int i = L, k = 0, end_i = 0;
        int guard = 8 * (L + M) + 64;
        while (guard-- > 0) {
            // defensive: a numerically-degenerate matrix must not walk out
            // of bounds
            if (i < 0 || k < 0 || k > M) break;
            if ((state == 2 || state == 4) && i < 1) break;
            if (state == 0) {          // C
                double o0 = i > 0 ? xCv[i - 1] + xC[0] : NEGMASS;
                double o1 = xEv[i] + xE[1];
                double two[2] = {o0, o1};
                if (choose(rng, two, 2) == 0) i--;
                else state = 1;
            } else if (state == 1) {   // E
                end_i = i;
                for (int kk = 0; kk < W; kk++) { uM[kk] = 0; uI[kk] = 0; }
                for (int kk = 1; kk <= M; kk++) lp[kk - 1] = Mm[(size_t)i * W + kk];
                lp[M] = Dm[(size_t)i * W + M];
                int c = choose(rng, lp, M + 1);
                if (c == M) { state = 3; k = M; }
                else { state = 2; k = c + 1; }
            } else if (state == 2) {   // M
                uM[k] += 1;
                double o[4];
                o[0] = k >= 2 ? Mm[(size_t)(i - 1) * W + k - 1] + tMM[k - 1] : NEGMASS;
                o[1] = k >= 2 ? Im[(size_t)(i - 1) * W + k - 1] + tIM[k - 1] : NEGMASS;
                o[2] = k >= 2 ? Dm[(size_t)(i - 1) * W + k - 1] + tDM[k - 1] : NEGMASS;
                o[3] = xBv[i - 1] + tBM[k - 1];
                int c = choose(rng, o, 4);
                i--;
                if (c == 3) {
                    // domain span complete: record + trace null2
                    if (nspans < max_spans) {
                        spans_out[3 * nspans] = s;
                        spans_out[3 * nspans + 1] = i + 1;
                        spans_out[3 * nspans + 2] = end_i;
                        nspans++;
                    }
                    double tot = 0;
                    for (int kk = 0; kk <= M; kk++) tot += uM[kk] + uI[kk];
                    if (tot > 0) {
                        // null2[x] = sum_k (uM[k] odds_m[x,k] + uI[k] odds_i[x,k]) / tot
                        for (int pos = i + 1; pos <= end_i; pos++) {
                            uint8_t x = dsq[pos - 1];
                            if (x >= K) continue;
                            double v = 0;
                            const double* om_ = odds_m + (size_t)x * W;
                            const double* oi_ = odds_i + (size_t)x * W;
                            for (int kk = 1; kk <= M; kk++)
                                v += uM[kk] * om_[kk] + uI[kk] * oi_[kk];
                            double val = v / tot;
                            n2acc[pos] += val > 1e-30 ? std::log(val) : -69.0;
                        }
                    }
                    state = 5;
                } else if (c == 0) k--;
                else if (c == 1) { state = 4; k--; }
                else { state = 3; k--; }
            } else if (state == 3) {   // D
                double o0 = Mm[(size_t)i * W + k - 1] + tMD[k - 1];
                double o1 = Dm[(size_t)i * W + k - 1] + tDD[k - 1];
                double two[2] = {o0, o1};
                if (choose(rng, two, 2) == 0) { state = 2; k--; }
                else k--;
            } else if (state == 4) {   // I
                uI[k] += 1;
                double o0 = Mm[(size_t)(i - 1) * W + k] + tMI[k];
                double o1 = Im[(size_t)(i - 1) * W + k] + tII[k];
                double two[2] = {o0, o1};
                i--;
                if (choose(rng, two, 2) == 0) state = 2;
            } else if (state == 5) {   // B
                double o0 = xNv[i] + xN[1];
                double o1 = xJv[i] + xJ[1];
                double two[2] = {o0, o1};
                state = choose(rng, two, 2) == 0 ? 7 : 6;
            } else if (state == 6) {   // J
                double o0 = i > 0 ? xJv[i - 1] + xJ[0] : NEGMASS;
                double o1 = xEv[i] + xE[0];
                double two[2] = {o0, o1};
                if (choose(rng, two, 2) == 0) i--;
                else state = 1;
            } else {                   // N
                if (i == 0) break;
                i--;
            }
        }
    }
    delete[] uM; delete[] uI; delete[] lp;
    return nspans;
}

// ---------------------------------------------------------------------------
// SSV seeding for the long-targets (nhmmer) pipeline
// ---------------------------------------------------------------------------
//
// Quantized single-segment Viterbi scan over a long window: the per-row
// diagonal maximum is compared against a precomputed threshold (uint8 MSV
// units); rows where it crosses are reported as seed positions and the DP
// state is reset so one strong diagonal yields one seed burst instead of
// flooding the output.  The caller extends seeds by max_length and merges
// them into subwindows (p7_SSVFilter_longtarget +
// p7_pli_ExtendAndMergeWindows roles).

int64_t hmmdp_ssv_seed(
    const uint8_t* dsq, int64_t L,
    const int32_t* cost,     // [Kp, M] quantized biased emission costs
    int32_t bias_b, int32_t xBv,   // fixed diagonal entry value
    int32_t thresh,          // report rows where max_k sv >= thresh
    int32_t M, int32_t Kp,
    int64_t* pos_out, int64_t max_out) {
    (void)Kp;
    // state buffers carry a leading slot pinned to xBv so the k-1 shift
    // needs no edge branch; the row body is pure elementwise int32
    // (max/min/sub/relu + a max reduction), which the compiler
    // vectorizes -- this loop touches EVERY genome residue, it is the
    // nhmmer analog of the protein MSV hot loop
    int32_t* bufA = new int32_t[M + 1];
    int32_t* bufB = new int32_t[M + 1];
    for (int k = 0; k <= M; k++) bufA[k] = 0;
    bufA[0] = bufB[0] = xBv;
    int32_t* __restrict__ mpv = bufA;
    int32_t* __restrict__ nv = bufB;
    int64_t n = 0;
    const int32_t bias = bias_b;
    const int32_t xb = xBv;
    for (int64_t i = 1; i <= L; i++) {
        const int32_t* __restrict__ c = cost + (size_t)dsq[i - 1] * M;
        int32_t mx = 0;
        for (int k = 1; k <= M; k++) {
            int32_t v = std::max(mpv[k - 1], xb);
            v = std::min(v + bias, 255) - c[k - 1];
            v = std::max(v, 0);
            nv[k] = v;
            mx = std::max(mx, v);
        }
        if (mx >= thresh) {
            if (n < max_out) pos_out[n] = i;
            n++;
            for (int k = 1; k <= M; k++) nv[k] = 0;
        }
        std::swap(mpv, nv);
    }
    delete[] bufA; delete[] bufB;
    return n < max_out ? n : max_out;
}

// Quantized MSV filter score (p7_MSVFilter uint8 semantics, integer
// arithmetic -- bit-identical to ops/reference.py msv_score_quantized).
// Returns the score in nats, or 1e30 on uint8 overflow (certainly
// passing; the caller maps it to +inf).
double hmmdp_msv_quant(
    const uint8_t* dsq, int64_t L,
    const int32_t* cost,           // [Kp, M]
    int32_t bias_b, int32_t base_b, int32_t tjb_b,
    int32_t tec_b, int32_t tbm_b, double scale_b,
    int32_t M, int32_t Kp) {
    (void)Kp;
    int32_t* bufA = new int32_t[M + 1];
    int32_t* bufB = new int32_t[M + 1];
    for (int k = 0; k <= M; k++) bufA[k] = 0;
    int32_t* __restrict__ mpv = bufA;
    int32_t* __restrict__ nv = bufB;
    int32_t xJ = 0;
    int32_t xB = std::max(0, base_b - tjb_b);
    const int32_t ovf = 255 - bias_b;
    for (int64_t i = 1; i <= L; i++) {
        const int32_t xBv = std::max(0, xB - tbm_b);
        const int32_t* __restrict__ c = cost + (size_t)dsq[i - 1] * M;
        mpv[0] = xBv;
        int32_t mx = 0;
        for (int k = 1; k <= M; k++) {
            int32_t v = std::max(mpv[k - 1], xBv);
            v = std::min(v + bias_b, 255) - c[k - 1];
            v = std::max(v, 0);
            nv[k] = v;
            mx = std::max(mx, v);
        }
        if (mx >= ovf) { delete[] bufA; delete[] bufB; return 1e30; }
        xJ = std::max(xJ, mx - tec_b);
        xB = std::max(base_b, xJ) - tjb_b;
        std::swap(mpv, nv);
    }
    delete[] bufA; delete[] bufB;
    return ((double)xJ - (double)tjb_b - (double)base_b) / scale_b - 3.0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full domain definition driver (p7_domaindef_ByPosteriorHeuristics role)
// ---------------------------------------------------------------------------
//
// One call per Forward-gate survivor: runs the full-sequence Forward/
// Backward parsers, finds regions from the special-state posteriors
// (rt1/rt2 heuristics), resolves multi-domain regions by stochastic
// traceback clustering (rt3 + spensemble consensus), rescores every
// envelope in unihit mode with null2 correction and an optimal-accuracy
// alignment, and returns packed domain records + traces.  This is the
// reference's C-side postprocessing (p7_domaindef.c, null2.c, optacc.c)
// rebuilt for the TPU pipeline: the filters run batched on device, and
// only the rare survivors reach this host code.

// Per-phase wall-time accumulators (seconds), indexed:
// 0=full fwd  1=full bck  2=decode+regions  3=env fwd/bck  4=env decode
// 5=null2  6=optacc+trace  7=stotrace cluster.  Diagnostic only; read
// through ctypes (ops/native.py phase_times).  Accumulated thread_local
// (domaindef runs concurrently on the engine's worker pool; a shared
// array would race) and summed across threads on read: each thread
// registers its block in a mutex-guarded list the first time it adds.
#include <mutex>
#include <vector>
namespace {
struct PhaseBlock { double s[8] = {0}; };
std::mutex g_phase_mu;
std::vector<PhaseBlock*> g_phase_blocks;
thread_local PhaseBlock* t_phase = nullptr;
inline void phase_add(int i, double dt) {
    if (!t_phase) {
        t_phase = new PhaseBlock();   // leaked per thread: bounded by pool
        std::lock_guard<std::mutex> lk(g_phase_mu);
        g_phase_blocks.push_back(t_phase);
    }
    t_phase->s[i] += dt;
}
}  // namespace

extern "C" void hmmdp_phase_get(double* out8) {
    std::lock_guard<std::mutex> lk(g_phase_mu);
    for (int i = 0; i < 8; i++) out8[i] = 0.0;
    for (PhaseBlock* b : g_phase_blocks)
        for (int i = 0; i < 8; i++) out8[i] += b->s[i];
}

extern "C" void hmmdp_phase_reset() {
    std::lock_guard<std::mutex> lk(g_phase_mu);
    for (PhaseBlock* b : g_phase_blocks)
        for (int i = 0; i < 8; i++) b->s[i] = 0.0;
}

namespace {

#include <time.h>
inline double clock_s(clockid_t clock) {
    struct timespec ts;
    clock_gettime(clock, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}
inline double now_s() { return clock_s(CLOCK_MONOTONIC); }

// Per-thread wall and CPU seconds inside the calls the engine's pool
// makes (hmmdp_domaindef, hmmdp_viterbi, hmmdp_bias_filter_idx), read by
// ops/native.py call_times.  Taken here, where ctypes has released the
// GIL, so the clock reads hold no GIL and the wait to retake it on
// return stays out.  The CPU interval holds the wall interval.
thread_local double t_call_s[2] = {0.0, 0.0};
struct CallTimer {
    double c0 = clock_s(CLOCK_THREAD_CPUTIME_ID);
    double w0 = now_s();
    ~CallTimer() {
        t_call_s[0] += now_s() - w0;
        t_call_s[1] += clock_s(CLOCK_THREAD_CPUTIME_ID) - c0;
    }
};

constexpr double RT1_DEF = 0.25;

struct Specials {
    double xE[2], xN[2], xJ[2], xC[2];
    void config(int Ltarget, bool multihit) {
        double nj = multihit ? 1.0 : 0.0;
        double pmove = (2.0 + nj) / (Ltarget + 2.0 + nj);
        double lloop = std::log(1.0 - pmove), lmove = std::log(pmove);
        xN[0] = xJ[0] = xC[0] = lloop;
        xN[1] = xJ[1] = xC[1] = lmove;
        if (multihit) { xE[0] = std::log(0.5); xE[1] = std::log(0.5); }
        else          { xE[0] = NEGMASS;       xE[1] = 0.0; }
    }
};

// splitmix64: derive independent per-region seeds from the pipeline seed
inline uint64_t mix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

struct UnionFind {
    int* p;
    explicit UnionFind(int n) : p(new int[n]) { for (int i = 0; i < n; i++) p[i] = i; }
    ~UnionFind() { delete[] p; }
    int find(int x) { while (p[x] != x) { p[x] = p[p[x]]; x = p[x]; } return x; }
    void unite(int a, int b) { a = find(a); b = find(b); if (a != b) p[a] = b; }
};

template <typename T>
inline bool oa_close(T a, T b) {
    // traceback branch re-matching tolerance: scaled to the row DP's
    // precision (values are posterior sums <= L; f32 accumulates ~L*eps
    // of absolute error)
    if (std::is_same<T, float>::value)
        return std::fabs(a - b) < 2e-4f * std::max(1.0f, std::fabs((float)b))
               + 1e-5f;
    return std::fabs(a - b) < 1e-7 * std::max(1.0, std::fabs((double)b))
           + 1e-9;
}

//: device-rows domaindef calls that failed the audit prepass and fell
//: back to the exact host parsers (diagnostic, read via
//: hmmdp_marginal_count)
std::atomic<int64_t> g_ext_marginal{0};

// Control-flow replica of the region scan in hmmdp_domaindef, with no
// side effects: returns true when ANY threshold comparison lands within
// ``eps`` of flipping -- the f32 device rows could then produce
// different regions than the exact f64 parsers, so the caller recomputes
// exactly.  Must stay in lockstep with the real scan below.
static bool audit_region_marginal(
    const double* btot, const double* etot, const double* mocc,
    int L, double rt1, double rt2, double rt3, double eps) {
    int istart = -1;
    bool triggered = false;
    for (int jj = 1; jj <= L; jj++) {
        if (!triggered) {
            double d = mocc[jj] - (btot[jj] - btot[jj - 1]) - rt2;
            if (std::fabs(d) < eps) return true;
            if (d < 0.0) istart = jj;
            else if (istart == -1) istart = jj;
            if (std::fabs(mocc[jj] - rt1) < eps) return true;
            if (mocc[jj] >= rt1) triggered = true;
        } else {
            double d = mocc[jj] - (etot[jj] - etot[jj - 1]) - rt2;
            if (std::fabs(d) < eps) return true;
            if (d < 0.0) {
                const int ii = istart;
                double expected_n = 0.0;
                for (int z = ii; z <= jj; z++)
                    expected_n = std::max(expected_n,
                        std::min(etot[z] - etot[ii - 1],
                                 btot[jj] - btot[z]));
                if (std::fabs(expected_n - rt3) < eps) return true;
                istart = -1;
                triggered = false;
            }
        }
    }
    return false;
}

struct TraceBuf {
    int8_t* st; int32_t* k; int32_t* i; double* pp;
    int64_t n, cap;
    bool overflow = false;
    void push(char s, int kk, int ii, double p) {
        if (n >= cap) { overflow = true; return; }
        st[n] = (int8_t)s; k[n] = kk; i[n] = ii; pp[n] = p; n++;
    }
    void reverse_from(int64_t start) {
        int64_t a = start, b = n - 1;
        while (a < b) {
            std::swap(st[a], st[b]); std::swap(k[a], k[b]);
            std::swap(i[a], i[b]); std::swap(pp[a], pp[b]);
            a++; b--;
        }
    }
};

}  // namespace


namespace {

inline int choose_lin(Rng& rng, const double* w, int n) {
    double tot = 0.0;
    for (int i = 0; i < n; i++) tot += w[i];
    if (tot <= 0.0) return 0;
    double u = rng.uniform() * tot;
    for (int i = 0; i < n; i++) {
        u -= w[i];
        if (u <= 0) return i;
    }
    return n - 1;
}

// Odds-space stochastic traceback ensemble (internal).  Matrices are raw
// odds with per-row log scales (keep==2 layout); parser specials are in
// log space.  Same sampling distribution as hmmdp_stotrace, ~5x fewer
// transcendentals (the E-state draw over M+1 options is exp-free).
int32_t stotrace_odds(
    const uint8_t* dsq, int32_t L,
    const float* Mm, const float* Im, const float* Dm,      // odds [L+1, W]
    const double* rsc,                                      // [L+1] log scale
    const double* xNv, const double* xBv, const double* xEv,
    const double* xCv, const double* xJv,                   // [L+1] log
    const ExpProf& P,
    const double* xE, const double* xN, const double* xJ, const double* xC,
    const double* odds_m, const double* odds_i,
    int32_t M, int32_t K, int32_t nsamples, uint64_t seed,
    int32_t* spans_out, int32_t max_spans, double* n2acc) {
    const int W = M + 1;
    Rng rng(seed);
    double* uM = new double[W];
    double* uI = new double[W];
    double* lp = new double[W + 1];
    // Hoisted B-entry factors: the M-state draw's B option is
    // exp(xBv[i-1] - rsc[i-1]) * eBM[k-1]; computing the exp per ROW
    // (instead of a log+exp pair per STEP) removes the two
    // transcendentals from the sampling inner loop.
    double* exB = new double[L + 1];
    for (int i2 = 0; i2 <= L; i2++) {
        double bl = xBv[i2] - rsc[i2];
        exB[i2] = bl > -690.0 ? std::exp(std::min(bl, 690.0)) : 0.0;
    }
    // Hoisted special-state selection probabilities: the C / J / B
    // draws are binary choices between LOG-space options, and the
    // two-exp `choose` per residue step dominated the whole ensemble
    // (hundreds of C/J dwell steps x 200 samples x 2 exp each).  The
    // per-row probability P(option 0) is sample-independent, so ONE
    // vectorizable pass per region replaces every in-loop
    // transcendental; the RNG stream and decisions are unchanged
    // (u*tot <= e0  <=>  u <= e0/tot, up to 1-ulp boundaries).
    // p > 1.5 is the "degenerate" sentinel: choose() picks option 0
    // WITHOUT consuming a draw when both options are -inf, and the
    // replacement must keep the RNG stream bit-identical
    auto p0_of = [](double o0, double o1) -> double {
        double mx = std::max(o0, o1);
        if (mx <= -5e29) return 2.0;
        double e0 = o0 > -5e29 ? std::exp(o0 - mx) : 0.0;
        double e1 = o1 > -5e29 ? std::exp(o1 - mx) : 0.0;
        return e0 / (e0 + e1);
    };
    double* pC = new double[L + 1];
    double* pJ = new double[L + 1];
    double* pB = new double[L + 1];
    for (int i2 = 0; i2 <= L; i2++) {
        pC[i2] = p0_of(i2 > 0 ? xCv[i2 - 1] + xC[0] : NEGMASS,
                       xEv[i2] + xE[1]);
        pJ[i2] = p0_of(i2 > 0 ? xJv[i2 - 1] + xJ[0] : NEGMASS,
                       xEv[i2] + xE[0]);
        pB[i2] = p0_of(xNv[i2] + xN[1], xJv[i2] + xJ[1]);
    }
    int nspans = 0;
    for (int kk = 0; kk < W; kk++) { uM[kk] = 0; uI[kk] = 0; }
    int kmin = W, kmax = 0;   // used-k range of the CURRENT span: the
    // null2 usage dots and the zeroing pass then touch only the states
    // the sampled domain actually visited instead of all M (spans
    // typically cover a fraction of the model)

    for (int s = 0; s < nsamples; s++) {
        int state = 0;  // 0=C 1=E 2=M 3=D 4=I 5=B 6=J 7=N
        int i = L, k = 0, end_i = 0;
        int guard = 8 * (L + M) + 64;
        while (guard-- > 0) {
            if (i < 0 || k < 0 || k > M) break;
            if ((state == 2 || state == 4) && i < 1) break;
            if (state == 0) {          // C (hoisted probabilities)
                if (pC[i] > 1.5 || rng.uniform() <= pC[i]) i--;
                else state = 1;
            } else if (state == 1) {   // E: odds row i, exp-free
                end_i = i;
                for (int kk = kmin; kk <= kmax; kk++) {
                    uM[kk] = 0; uI[kk] = 0;
                }
                kmin = W; kmax = 0;
                const float* Mr = Mm + (size_t)i * W;
                for (int kk = 1; kk <= M; kk++) lp[kk - 1] = Mr[kk];
                lp[M] = Dm[(size_t)i * W + M];
                int c = choose_lin(rng, lp, M + 1);
                if (c == M) { state = 3; k = M; }
                else { state = 2; k = c + 1; }
            } else if (state == 2) {   // M
                uM[k] += 1;
                if (k < kmin) kmin = k;
                if (k > kmax) kmax = k;
                const size_t om1 = (size_t)(i - 1) * W;
                double o[4];
                o[0] = k >= 2 ? Mm[om1 + k - 1] * P.eMM[k - 1] : 0.0;
                o[1] = k >= 2 ? Im[om1 + k - 1] * P.eIM[k - 1] : 0.0;
                o[2] = k >= 2 ? Dm[om1 + k - 1] * P.eDM[k - 1] : 0.0;
                o[3] = exB[i - 1] * P.eBM[k - 1];
                int c = choose_lin(rng, o, 4);
                i--;
                if (c == 3) {
                    if (nspans < max_spans) {
                        spans_out[3 * nspans] = s;
                        spans_out[3 * nspans + 1] = i + 1;
                        spans_out[3 * nspans + 2] = end_i;
                        nspans++;
                    }
                    double tot = 0;
                    for (int kk = kmin; kk <= kmax; kk++)
                        tot += uM[kk] + uI[kk];
                    const int k0 = kmin > 1 ? kmin : 1;
                    if (tot > 0) {
                        // hoist the per-position M-dot into one table per
                        // residue type (identical sums, ~7x fewer ops:
                        // K x M instead of span_len x M), and take the
                        // log once per TYPE instead of once per position;
                        // the k loop covers only [kmin, kmax] -- usage
                        // counts outside the span's visited states are 0
                        double lcorex[64];
                        for (int x = 0; x < K; x++) {
                            double v = 0;
                            const double* om_ = odds_m + (size_t)x * W;
                            const double* oi_ = odds_i + (size_t)x * W;
                            for (int kk = k0; kk <= kmax; kk++)
                                v += uM[kk] * om_[kk] + uI[kk] * oi_[kk];
                            v /= tot;
                            lcorex[x] = v > 1e-30 ? std::log(v) : -69.0;
                        }
                        for (int pos = i + 1; pos <= end_i; pos++) {
                            uint8_t x = dsq[pos - 1];
                            if (x >= K) continue;
                            n2acc[pos] += lcorex[x];
                        }
                    }
                    state = 5;
                } else if (c == 0) k--;
                else if (c == 1) { state = 4; k--; }
                else { state = 3; k--; }
            } else if (state == 3) {   // D: odds row i
                const size_t oi_ = (size_t)i * W;
                double w0 = Mm[oi_ + k - 1] * P.eMD[k - 1];
                double w1 = Dm[oi_ + k - 1] * P.eDD[k - 1];
                double two[2] = {w0, w1};
                if (choose_lin(rng, two, 2) == 0) { state = 2; k--; }
                else k--;
            } else if (state == 4) {   // I: odds row i-1
                uI[k] += 1;
                if (k < kmin) kmin = k;
                if (k > kmax) kmax = k;
                const size_t om1 = (size_t)(i - 1) * W;
                double w0 = Mm[om1 + k] * P.eMI[k];
                double w1 = Im[om1 + k] * P.eII[k];
                double two[2] = {w0, w1};
                i--;
                if (choose_lin(rng, two, 2) == 0) state = 2;
            } else if (state == 5) {   // B (hoisted probabilities)
                state = (pB[i] > 1.5 || rng.uniform() <= pB[i]) ? 7 : 6;
            } else if (state == 6) {   // J
                if (pJ[i] > 1.5 || rng.uniform() <= pJ[i]) i--;
                else state = 1;
            } else {                   // N
                if (i == 0) break;
                i--;
            }
        }
    }
    delete[] uM; delete[] uI; delete[] lp; delete[] exB;
    delete[] pC; delete[] pJ; delete[] pB;
    return nspans;
}

}  // namespace

extern "C" {

// Returns number of domains written, -1 if a buffer was too small
// (caller falls back / retries), or -3 if device-provided rows were
// threshold-marginal (caller retries without them).  out_scalars[6]:
//   [0]=fwdsc  [1]=nexpected  [2]=nregions  [3]=nclustered
//   [4]=noverlaps  [5]=nenvelopes
//
// ``ext_rows`` (optional, may be NULL): device-computed region rows
// [3 * (L+1)] = btot, etot, mocc (see ops/rows_pallas.py) with the
// Forward score in ``ext_fwdsc``; when given, the full-sequence
// Forward/Backward parsers and the special-state decode are SKIPPED
// (they ran on the TPU) and every region-finding comparison is audited
// against ``audit_eps`` -- a comparison landing within the epsilon of
// its threshold returns -3 so the caller can redo the target with the
// exact host parsers (the f32-prefilter + f64-recheck margin pattern).
static int32_t domaindef_core(
    const uint8_t* dsq, int32_t L,
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc,        // [Kp, W] log
    int32_t M, int32_t K, int32_t Kp,
    const double* odds_m, const double* odds_i,  // [K, W] odds
    const double* degw,                          // [Kp, K] degeneracy weights
    const uint8_t* deg_one,                      // [Kp] 1 => null2 = 1.0
    int32_t do_null2, uint64_t seed, int32_t nsamples,
    double rt1, double rt2, double rt3,
    double fwd_min,                              // bail if fwdsc < fwd_min
    double* out_scalars,                         // [6]
    double* n2sc,                                // [L+1], zeroed by caller
    int32_t* dom_int,                            // [max_dom * 6]
    double* dom_dbl,                             // [max_dom * 3]
    int32_t max_dom,
    int8_t* tr_st, int32_t* tr_k, int32_t* tr_i, double* tr_pp,
    int64_t* tr_off,                             // [max_dom + 1]
    int64_t max_tr,
    const void* core_handle,                     // cached ExpCore or NULL
    const double* ext_rows,                      // [3*(L+1)] or NULL
    double ext_fwdsc, double audit_eps) {

    const int W = M + 1;
    Specials sm; sm.config(L, true);    // multihit, full-length model
    Specials su; su.config(L, false);   // unihit, full-length model
    const ExpCore* core = reinterpret_cast<const ExpCore*>(core_handle);
    ExpCore* local_core = nullptr;
    if (core == nullptr) {
        local_core = new ExpCore(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII,
                                 msc, isc, M, Kp);
        core = local_core;
    }
    ExpProf Pm(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII, msc, isc,
               sm.xE, sm.xN, sm.xJ, sm.xC, M, Kp, core);
    ExpProf Pu(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII, msc, isc,
               su.xE, su.xN, su.xJ, su.xC, M, Kp, core);

    Arena::Mark call_mark = g_arena.mark();
    const double* btot;
    const double* etot;
    const double* mocc;
    double fwdsc;
    bool used_ext = false;
    if (ext_rows != nullptr) {
        // device-resident parsers: the TPU already ran the full-L
        // Forward/Backward and the special-state decode.  Two cheap
        // prepasses decide whether the f32 rows can be trusted BEFORE
        // any envelope work: (a) the F3 gate margin (the f32 device
        // score must not decide a boundary gate), (b) a control-flow
        // replica of the region scan asserting every threshold
        // comparison is at least audit_eps away from flipping.  If
        // either is marginal the exact host parsers run below, in this
        // same call -- no second envelope pass, no extra round trip.
        const double* bt = ext_rows;
        const double* et = ext_rows + (L + 1);
        const double* mo = ext_rows + 2 * (L + 1);
        bool marginal = audit_eps > 0.0
            && std::fabs(ext_fwdsc - fwd_min) < audit_eps * 50.0;
        if (!marginal && ext_fwdsc < fwd_min) {
            out_scalars[0] = ext_fwdsc;
            out_scalars[1] = 0.0; out_scalars[2] = 0.0;
            out_scalars[3] = 0.0;
            out_scalars[4] = 0.0; out_scalars[5] = 0.0;
            g_arena.release(call_mark);
            delete local_core;
            return 0;
        }
        if (!marginal)
            marginal = audit_region_marginal(bt, et, mo, L, rt1, rt2,
                                             rt3, audit_eps);
        if (!marginal) {
            fwdsc = ext_fwdsc;
            btot = bt; etot = et; mocc = mo;
            used_ext = true;
        } else {
            g_ext_marginal.fetch_add(1, std::memory_order_relaxed);
        }
    }
    if (!used_ext) {
    // ---- full-sequence multihit Forward/Backward parsers ----
    // keep=3: specials stored LINEAR with per-row log scales -- avoids
    // 4-5 log() calls per row in each parser; the decode below pays one
    // vectorizable exp() pass per posterior stream instead
    double* fxN = g_arena.alloc(L + 1); double* fxB = g_arena.alloc(L + 1);
    double* fxE = g_arena.alloc(L + 1); double* fxC = g_arena.alloc(L + 1);
    double* fxJ = g_arena.alloc(L + 1);
    double* bxN = g_arena.alloc(L + 1); double* bxB = g_arena.alloc(L + 1);
    double* bxE = g_arena.alloc(L + 1); double* bxC = g_arena.alloc(L + 1);
    double* bxJ = g_arena.alloc(L + 1);
    double* rsf = g_arena.alloc(L + 1);
    double* rsb = g_arena.alloc(L + 1);
    float dummy[1];
    double t_ = now_s();
    fwdsc = fwd_impl<float>(Pm, dsq, L, sm.xN, M, Kp,
                            fxN, fxB, fxE, fxC, fxJ,
                            dummy, dummy, dummy, 3, rsf);
    phase_add(0, now_s() - t_);
    if (fwdsc < fwd_min) {
        // exact-score gate miss: the caller's F3 re-check would drop this
        // target anyway, so skip Backward/decode/rescoring entirely
        out_scalars[0] = fwdsc;
        out_scalars[1] = 0.0; out_scalars[2] = 0.0; out_scalars[3] = 0.0;
        out_scalars[4] = 0.0; out_scalars[5] = 0.0;
        g_arena.release(call_mark);
        delete local_core;
        return 0;
    }
    t_ = now_s();
    bck_impl<float>(Pm, dsq, L, M, Kp,
                    bxN, bxB, bxE, bxC, bxJ, dummy, dummy, dummy, 3, rsb);
    phase_add(1, now_s() - t_);
    t_ = now_s();

    // ---- decode_specials: btot / etot / mocc (linear specials x
    // row-scale exponentials; the ef* passes auto-vectorize) ----
    double* btot_w = g_arena.alloc(L + 1);
    double* etot_w = g_arena.alloc(L + 1);
    double* mocc_w = g_arena.alloc(L + 1);
    {
        double* __restrict__ ef_bb = g_arena.alloc(L + 1);
        double* __restrict__ ef_ee = g_arena.alloc(L + 1);
        double* __restrict__ ef_nx = g_arena.alloc(L + 1);
        for (int i = 1; i <= L; i++) {
            ef_bb[i] = std::exp(rsf[i - 1] + rsb[i - 1] - fwdsc);
            ef_ee[i] = std::exp(rsf[i] + rsb[i] - fwdsc);
            ef_nx[i] = std::exp(rsf[i - 1] + rsb[i] - fwdsc);
        }
        const double eLoop = std::exp(sm.xN[0]);   // == eJ[0] == eC[0]
        btot_w[0] = etot_w[0] = mocc_w[0] = 0.0;
        for (int i = 1; i <= L; i++) {
            btot_w[i] = btot_w[i - 1] + fxB[i - 1] * bxB[i - 1] * ef_bb[i];
            etot_w[i] = etot_w[i - 1] + fxE[i] * bxE[i] * ef_ee[i];
            double pN = fxN[i - 1] * eLoop * bxN[i] * ef_nx[i];
            double pJ = fxJ[i - 1] * eLoop * bxJ[i] * ef_nx[i];
            double pC = fxC[i - 1] * eLoop * bxC[i] * ef_nx[i];
            mocc_w[i] = 1.0 - (pN + pJ + pC);
        }
    }
    btot = btot_w; etot = etot_w; mocc = mocc_w;

    phase_add(2, now_s() - t_);
    }

    int ndom = 0;
    int nregions = 0, nclustered = 0, noverlaps = 0, nenvelopes = 0;
    bool fail = false;
    tr_off[0] = 0;

    // scratch reused across rescore calls sized per window on demand
    // (regions are typically a few hundred residues)

    // ---- rescore one envelope [a..b] (1-based, inclusive) ----
    auto rescore = [&](int a, int b, bool null2_done) -> bool {
        if (fail || ndom >= max_dom) { fail = true; return false; }
        const int Ld = b - a + 1;
        const uint8_t* win = dsq + (a - 1);
        const size_t rows = (size_t)(Ld + 1) * W;
        Arena::Mark rmark = g_arena.mark();
        float* fM = g_arena.alloc<float>(rows);
        float* fI = g_arena.alloc<float>(rows);
        float* fD = g_arena.alloc<float>(rows);
        double* wfxN = g_arena.alloc(Ld + 1);
        double* wfxB = g_arena.alloc(Ld + 1);
        double* wfxE = g_arena.alloc(Ld + 1);
        double* wfxC = g_arena.alloc(Ld + 1);
        double* wfxJ = g_arena.alloc(Ld + 1);
        double* fsc_row = g_arena.alloc(Ld + 1);
        // keep=4: raw odds matrices + LINEAR specials (no per-row logs)
        double tt = now_s();
        double envsc = fwd_impl<float>(Pu, win, Ld, su.xN, M, Kp,
                                       wfxN, wfxB, wfxE, wfxC, wfxJ,
                                       fM, fI, fD, 4, fsc_row);
        phase_add(3, now_s() - tt); tt = now_s();

        // fused Backward + posterior decode (one pass, no stored
        // backward matrices; see bck_decode_impl)
        float* ppM = g_arena.alloc<float>(rows);
        float* ppI = g_arena.alloc<float>(rows);
        float* ppN = g_arena.alloc<float>(Ld + 1);
        float* ppJ = g_arena.alloc<float>(Ld + 1);
        float* ppC = g_arena.alloc<float>(Ld + 1);
        bck_decode_impl<float>(Pu, win, Ld, M, Kp, fM, fI,
                               wfxN, wfxJ, wfxC, fsc_row, envsc,
                               ppM, ppI, ppN, ppJ, ppC);

        phase_add(4, now_s() - tt); tt = now_s();
        double domcorrection = 0.0;
        if (do_null2 && !null2_done) {
            // null2 by expectation over all states incl. N/C/J flank mass
            float* __restrict__ wM = g_arena.zalloc<float>(W);
            float* __restrict__ wI = g_arena.zalloc<float>(W);
            double wX = 0.0;
            for (int i2 = 1; i2 <= Ld; i2++) {
                const size_t o = (size_t)i2 * W;
                const float* __restrict__ pMo = ppM + o;
                const float* __restrict__ pIo = ppI + o;
#pragma GCC ivdep
                for (int kk = 0; kk < W; kk++) {
                    wM[kk] += pMo[kk]; wI[kk] += pIo[kk];
                }
                wX += (double)ppN[i2] + ppJ[i2] + ppC[i2];
            }
            double* n2core = g_arena.alloc(K);
            for (int x = 0; x < K; x++) {
                double v = 0.0;
                const double* om_ = odds_m + (size_t)x * W;
                const double* oi_ = odds_i + (size_t)x * W;
                for (int kk = 1; kk <= M; kk++)
                    v += om_[kk] * wM[kk] + oi_[kk] * wI[kk];
                n2core[x] = (v + wX) / (double)Ld;
            }
            for (int pos = a; pos <= b; pos++) {
                uint8_t x = dsq[pos - 1];
                double val;
                if (x < K) val = n2core[x];
                else if (deg_one[x]) val = 1.0;
                else {
                    val = 0.0;
                    const double* dw = degw + (size_t)x * K;
                    for (int c = 0; c < K; c++) val += dw[c] * n2core[c];
                }
                n2sc[pos] = val > 1e-300 ? std::log(val) : -700.0;
            }
        }
        if (do_null2)
            for (int pos = a; pos <= b; pos++) domcorrection += n2sc[pos];

        phase_add(5, now_s() - tt); tt = now_s();
        // optimal accuracy DP + traceback
        const float NEGF = (float)NEGMASS;
        float* gMM = g_arena.alloc<float>(M);
        float* gIM = g_arena.alloc<float>(M);
        float* gDM = g_arena.alloc<float>(M);
        float* gMD = g_arena.alloc<float>(M);
        float* gDD = g_arena.alloc<float>(M);
        float* gBM = g_arena.alloc<float>(M);
        float* gMI = g_arena.alloc<float>(W);
        float* gII = g_arena.alloc<float>(W);
        for (int kk = 0; kk < M; kk++) {
            gMM[kk] = tMM[kk] > -5e29 ? 0.0f : NEGF;
            gIM[kk] = tIM[kk] > -5e29 ? 0.0f : NEGF;
            gDM[kk] = tDM[kk] > -5e29 ? 0.0f : NEGF;
            gMD[kk] = tMD[kk] > -5e29 ? 0.0f : NEGF;
            gDD[kk] = tDD[kk] > -5e29 ? 0.0f : NEGF;
            gBM[kk] = tBM[kk] > -5e29 ? 0.0f : NEGF;
        }
        for (int kk = 0; kk < W; kk++) {
            gMI[kk] = tMI[kk] > -5e29 ? 0.0f : NEGF;
            gII[kk] = tII[kk] > -5e29 ? 0.0f : NEGF;
        }
        float* Mx = g_arena.alloc<float>(rows);
        float* Ix = g_arena.alloc<float>(rows);
        float* Dx = g_arena.alloc<float>(rows);
        float* oxN = g_arena.alloc<float>(Ld + 1);
        float* oxB = g_arena.alloc<float>(Ld + 1);
        float* oxE = g_arena.alloc<float>(Ld + 1);
        float* oxJ = g_arena.alloc<float>(Ld + 1);
        float* oxC = g_arena.alloc<float>(Ld + 1);
        int eJ_ok = su.xE[0] > -5e29 ? 1 : 0;
        double oasc = optacc_impl<float>(ppM, ppI, ppN, ppJ, ppC,
                                         gMM, gIM, gDM, gMD, gDD, gMI,
                                         gII, gBM, eJ_ok, Ld, M,
                                         Mx, Ix, Dx, oxN, oxB, oxE, oxJ,
                                         oxC);

        // OA traceback (p7_OATrace port; built reversed, then flipped)
        TraceBuf tb{tr_st, tr_k, tr_i, tr_pp, tr_off[ndom], max_tr};
        int64_t t_start = tb.n;
        {
            int i2 = Ld, kk = 0;
            char state = 'C';
            tb.push('T', 0, 0, 0.0);
            tb.push('C', 0, 0, 0.0);
            int guard = 8 * (Ld + M) + 64;
            while (!(state == 'N' && i2 == 0) && guard-- > 0 && !tb.overflow) {
                const size_t o = (size_t)i2 * W;
                const size_t om1 = o >= (size_t)W ? o - W : 0;
                if (state == 'C') {
                    if (i2 > 0 && oa_close(oxC[i2], oxC[i2 - 1] + ppC[i2])) {
                        tb.push('C', 0, i2, ppC[i2]); i2--;
                    } else { state = 'E'; tb.push('E', 0, 0, 0.0); }
                } else if (state == 'E') {
                    float mmax = NEGF;
                    int argm = 1;
                    for (int q = 1; q <= M; q++)
                        if (Mx[o + q] > mmax) { mmax = Mx[o + q]; argm = q; }
                    if (oa_close(oxE[i2], Dx[o + M])
                        && Dx[o + M] > mmax + 1e-9) {
                        state = 'D'; kk = M; tb.push('D', M, 0, 0.0);
                    } else { state = 'M'; kk = argm;
                             tb.push('M', kk, i2, ppM[o + kk]); }
                } else if (state == 'M') {
                    float v = Mx[o + kk] - ppM[o + kk];
                    float pm = Mx[om1 + kk - 1], pi_ = Ix[om1 + kk - 1];
                    float pd = Dx[om1 + kk - 1], pb = oxB[i2 - 1];
                    i2--;
                    const size_t o2 = (size_t)i2 * W;
                    if (oa_close(v, pb)) { state = 'B'; tb.push('B', 0, 0, 0.0); }
                    else if (oa_close(v, pm)) {
                        kk--; tb.push('M', kk, i2, ppM[o2 + kk]);
                    } else if (oa_close(v, pd)) {
                        state = 'D'; kk--; tb.push('D', kk, 0, 0.0);
                    } else if (oa_close(v, pi_)) {
                        state = 'I'; kk--; tb.push('I', kk, i2, ppI[o2 + kk]);
                    } else { state = 'B'; tb.push('B', 0, 0, 0.0); }
                } else if (state == 'D') {
                    if (kk >= 2 && oa_close(Dx[o + kk], Dx[o + kk - 1])) {
                        kk--; tb.push('D', kk, 0, 0.0);
                    } else {
                        kk--; state = 'M'; tb.push('M', kk, i2, ppM[o + kk]);
                    }
                } else if (state == 'I') {
                    float v = Ix[o + kk] - ppI[o + kk];
                    float pm = Mx[om1 + kk];
                    i2--;
                    const size_t o2 = (size_t)i2 * W;
                    if (oa_close(v, pm)) {
                        state = 'M'; tb.push('M', kk, i2, ppM[o2 + kk]);
                    } else tb.push('I', kk, i2, ppI[o2 + kk]);
                } else if (state == 'B') {
                    if (eJ_ok && oa_close(oxB[i2], oxJ[i2])
                        && oxJ[i2] > oxN[i2] - 1e-12) {
                        state = 'J'; tb.push('J', 0, 0, 0.0);
                    } else { state = 'N'; tb.push('N', 0, 0, 0.0); }
                } else if (state == 'J') {
                    if (i2 > 0 && oa_close(oxJ[i2], oxJ[i2 - 1] + ppJ[i2])) {
                        tb.push('J', 0, i2, ppJ[i2]); i2--;
                    } else { state = 'E'; tb.push('E', 0, 0, 0.0); }
                } else {  // N
                    if (i2 > 0) { tb.push('N', 0, i2, ppN[i2]); i2--; }
                    else break;
                }
            }
            tb.push('S', 0, 0, 0.0);
            tb.reverse_from(t_start);
        }

        // offset residue indices to sequence coords; alignment bounds
        int iali = 0, jali = 0, hmmfrom = 0, hmmto = 0;
        for (int64_t z = t_start; z < tb.n; z++) {
            if (tr_i[z] > 0) tr_i[z] += a - 1;
            if (tr_st[z] == 'M') {
                if (iali == 0) { iali = tr_i[z]; hmmfrom = tr_k[z]; }
                jali = tr_i[z]; hmmto = tr_k[z];
            }
        }

        phase_add(6, now_s() - tt);
        bool ok = !tb.overflow && iali != 0;
        if (tb.overflow) fail = true;
        if (ok) {
            dom_int[ndom * 6 + 0] = a;       dom_int[ndom * 6 + 1] = b;
            dom_int[ndom * 6 + 2] = iali;    dom_int[ndom * 6 + 3] = jali;
            dom_int[ndom * 6 + 4] = hmmfrom; dom_int[ndom * 6 + 5] = hmmto;
            dom_dbl[ndom * 3 + 0] = envsc;
            dom_dbl[ndom * 3 + 1] = domcorrection;
            dom_dbl[ndom * 3 + 2] = oasc;
            ndom++;
            tr_off[ndom] = tb.n;
        }
        g_arena.release(rmark);
        return ok;
    };

    // ---- region scan ----
    int istart = -1;
    bool triggered = false;
    int region_idx = 0;
    for (int jj = 1; jj <= L && !fail; jj++) {
        if (!triggered) {
            if (mocc[jj] - (btot[jj] - btot[jj - 1]) < rt2) istart = jj;
            else if (istart == -1) istart = jj;
            if (mocc[jj] >= rt1) triggered = true;
        } else if (mocc[jj] - (etot[jj] - etot[jj - 1]) < rt2) {
            const int ii = istart;
            nregions++;
            double expected_n = 0.0;
            for (int z = ii; z <= jj; z++)
                expected_n = std::max(expected_n,
                    std::min(etot[z] - etot[ii - 1], btot[jj] - btot[z]));
            if (expected_n >= rt3) {
                // --- multidomain region: stochastic traceback clustering ---
                double tt = now_s();
                nclustered++;
                const int Ld = jj - ii + 1;
                const uint8_t* win = dsq + (ii - 1);
                Specials sr; sr.config(Ld, true);
                const size_t rows = (size_t)(Ld + 1) * W;
                Arena::Mark gmark = g_arena.mark();
                float* rM = g_arena.alloc<float>(rows);
                float* rI = g_arena.alloc<float>(rows);
                float* rD = g_arena.alloc<float>(rows);
                double* rxN = g_arena.alloc(Ld + 1);
                double* rxB = g_arena.alloc(Ld + 1);
                double* rxE = g_arena.alloc(Ld + 1);
                double* rxC = g_arena.alloc(Ld + 1);
                double* rxJ = g_arena.alloc(Ld + 1);
                double* rrsc = g_arena.alloc(Ld + 1);
                ExpProf Pr(tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII, msc, isc,
                           sr.xE, sr.xN, sr.xJ, sr.xC, M, Kp, core);
                fwd_impl<float>(Pr, win, Ld, sr.xN, M, Kp,
                                rxN, rxB, rxE, rxC, rxJ, rM, rI, rD, 2,
                                rrsc);
                const int max_spans = nsamples * 16;
                int32_t* spans = new int32_t[3 * max_spans];
                double* n2acc = g_arena.zalloc(Ld + 2);
                uint64_t rseed = mix64(seed ^ mix64((uint64_t)region_idx + 1));
                const ExpProf& EP = Pr;
                int nsp = stotrace_odds(
                    win, Ld, rM, rI, rD, rrsc, rxN, rxB, rxE, rxC, rxJ,
                    EP, sr.xE, sr.xN, sr.xJ, sr.xC,
                    odds_m, odds_i, M, K, nsamples, rseed,
                    spans, max_spans, n2acc);
                if (do_null2)
                    for (int pos = 1; pos <= Ld; pos++)
                        n2sc[ii + pos - 1] = n2acc[pos] / nsamples;

                // dedup spans -> unique (a,b) with multiplicity + sample sets
                // envs from single-linkage clustering (>= 0.8 overlap of the
                // smaller), consensus posterior >= 0.25, endpoint p >= 0.02
                int nenv = 0;
                int* env_a = new int[nsp > 0 ? nsp : 1];
                int* env_b = new int[nsp > 0 ? nsp : 1];
                if (nsp > 0) {
                    // sort span indices by (a, b)
                    int* order = new int[nsp];
                    for (int t = 0; t < nsp; t++) order[t] = t;
                    std::sort(order, order + nsp, [&](int x, int y) {
                        if (spans[3 * x + 1] != spans[3 * y + 1])
                            return spans[3 * x + 1] < spans[3 * y + 1];
                        return spans[3 * x + 2] < spans[3 * y + 2];
                    });
                    int nu = 0;
                    int* ua = new int[nsp]; int* ub = new int[nsp];
                    int* uc = new int[nsp];
                    int* uoff = new int[nsp + 1];      // into usamp
                    int* usamp = new int[nsp];         // sample ids, grouped
                    uoff[0] = 0;
                    for (int t = 0; t < nsp;) {
                        int aa = spans[3 * order[t] + 1];
                        int bb = spans[3 * order[t] + 2];
                        int c = 0, w = uoff[nu];
                        while (t < nsp && spans[3 * order[t] + 1] == aa
                               && spans[3 * order[t] + 2] == bb) {
                            usamp[w + c] = spans[3 * order[t]];
                            c++; t++;
                        }
                        ua[nu] = aa; ub[nu] = bb; uc[nu] = c;
                        uoff[nu + 1] = w + c; nu++;
                    }
                    UnionFind uf(nu);
                    for (int x = 0; x < nu; x++) {
                        int lx = ub[x] - ua[x] + 1;
                        for (int y = x + 1; y < nu; y++) {
                            if (ua[y] > ub[x]) break;  // sorted by start
                            int ov = std::min(ub[x], ub[y])
                                     - std::max(ua[x], ua[y]) + 1;
                            int ly = ub[y] - ua[y] + 1;
                            if (ov > 0 && ov >= 0.8 * std::min(lx, ly))
                                uf.unite(x, y);
                        }
                    }
                    bool* seen = new bool[nsamples];
                    for (int root = 0; root < nu; root++) {
                        if (uf.find(root) != root) continue;
                        // gather members
                        std::memset(seen, 0, nsamples);
                        int nsup = 0, mtot = 0;
                        int amin = 1 << 30, bmax = 0;
                        for (int x = 0; x < nu; x++)
                            if (uf.find(x) == root) {
                                mtot += uc[x];
                                for (int q = uoff[x]; q < uoff[x + 1]; q++)
                                    if (!seen[usamp[q]]) {
                                        seen[usamp[q]] = true; nsup++;
                                    }
                            }
                        if ((double)nsup / nsamples < 0.25) continue;
                        // endpoint marginals: widest start/end with p>=0.02
                        int sa_min = 1 << 30, sb_max = 0;
                        for (int x = 0; x < nu; x++) {
                            if (uf.find(x) != root) continue;
                            // start marginal: sum multiplicities sharing ua[x]
                            int cs = 0, ce = 0;
                            for (int y = 0; y < nu; y++) {
                                if (uf.find(y) != root) continue;
                                if (ua[y] == ua[x]) cs += uc[y];
                                if (ub[y] == ub[x]) ce += uc[y];
                            }
                            if ((double)cs / mtot >= 0.02)
                                sa_min = std::min(sa_min, ua[x]);
                            if ((double)ce / mtot >= 0.02)
                                sb_max = std::max(sb_max, ub[x]);
                            amin = std::min(amin, ua[x]);
                            bmax = std::max(bmax, ub[x]);
                        }
                        int ea = sa_min != (1 << 30) ? sa_min : amin;
                        int eb = sb_max != 0 ? sb_max : bmax;
                        if (eb < ea) continue;
                        env_a[nenv] = ea + ii - 1;
                        env_b[nenv] = eb + ii - 1;
                        nenv++;
                    }
                    delete[] seen;
                    delete[] order; delete[] ua; delete[] ub; delete[] uc;
                    delete[] uoff; delete[] usamp;
                }
                delete[] spans;
                g_arena.release(gmark);
                phase_add(7, now_s() - tt);
                if (nenv == 0) { env_a[0] = ii; env_b[0] = jj; nenv = 1; }
                // sort envelopes by start
                for (int x = 1; x < nenv; x++)
                    for (int y = x; y > 0 &&
                         (env_a[y] < env_a[y - 1] ||
                          (env_a[y] == env_a[y - 1] && env_b[y] < env_b[y - 1]));
                         y--) {
                        std::swap(env_a[y], env_a[y - 1]);
                        std::swap(env_b[y], env_b[y - 1]);
                    }
                int last_end = 0;
                for (int e = 0; e < nenv && !fail; e++) {
                    if (env_a[e] <= last_end) noverlaps++;
                    last_end = env_b[e];
                    if (rescore(env_a[e], env_b[e], true)) nenvelopes++;
                }
                delete[] env_a; delete[] env_b;
            } else {
                if (rescore(ii, jj, false)) nenvelopes++;
            }
            region_idx++;
            istart = -1;
            triggered = false;
        }
    }

    double nexpected = etot[L];
    g_arena.release(call_mark);
    delete local_core;
    out_scalars[0] = fwdsc;
    out_scalars[1] = nexpected;
    out_scalars[2] = nregions;
    out_scalars[3] = nclustered;
    out_scalars[4] = noverlaps;
    out_scalars[5] = nenvelopes;
    return fail ? -1 : ndom;
}

int32_t hmmdp_domaindef(
    const uint8_t* dsq, int32_t L,
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc,
    int32_t M, int32_t K, int32_t Kp,
    const double* odds_m, const double* odds_i,
    const double* degw, const uint8_t* deg_one,
    int32_t do_null2, uint64_t seed, int32_t nsamples,
    double rt1, double rt2, double rt3, double fwd_min,
    double* out_scalars, double* n2sc,
    int32_t* dom_int, double* dom_dbl, int32_t max_dom,
    int8_t* tr_st, int32_t* tr_k, int32_t* tr_i, double* tr_pp,
    int64_t* tr_off, int64_t max_tr,
    const void* core_handle, const double* ext_rows,
    double ext_fwdsc, double audit_eps) {
    CallTimer call_timer;
    return domaindef_core(
        dsq, L, tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII, msc, isc, M, K, Kp,
        odds_m, odds_i, degw, deg_one, do_null2, seed, nsamples,
        rt1, rt2, rt3, fwd_min, out_scalars, n2sc, dom_int, dom_dbl,
        max_dom, tr_st, tr_k, tr_i, tr_pp, tr_off, max_tr, core_handle,
        ext_rows, ext_fwdsc, audit_eps);
}

// ABI marker: present iff hmmdp_domaindef takes the ext_rows tail
// (ops/native.py probes it so a stale .so forces a rebuild)
int32_t hmmdp_has_ext_rows() { return 1; }

// This thread's sums of CallTimer: out2 = {wall, cpu}.
void hmmdp_call_times(double* out2) {
    out2[0] = t_call_s[0];
    out2[1] = t_call_s[1];
}

int64_t hmmdp_marginal_count() {
    return g_ext_marginal.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// FLogsum-table Forward (E-value calibration scorer)
// ---------------------------------------------------------------------------
//
// HMMER's generic log-space Forward sums through a 16,000-entry lookup
// of log(1 + exp(-x)) at 1/500-nat resolution (logsum.c, initialized at
// import in the reference, plan7.pyx:9655).  The truncated-index lookup
// systematically overestimates every logsum by up to 1/500 nat, which
// accumulates to the few-tenths-of-a-bit tau offset a real hmmbuild
// shows vs an exact-logsumexp Forward.  Used ONLY by
// Builder.calibrate's tau simulation; search paths stay exact.

static const float* flogsum_table() {
    static float tbl[16000];
    static std::atomic<bool> init{false};
    if (!init.load(std::memory_order_acquire)) {
        for (int i = 0; i < 16000; i++)
            tbl[i] = (float)std::log(1.0 + std::exp(-(double)i / 500.0));
        init.store(true, std::memory_order_release);
    }
    return tbl;
}

static inline float flogsum(const float* tbl, float a, float b) {
    const float mx = a > b ? a : b;
    const float mn = a > b ? b : a;
    if (mn <= -5e28f || mx - mn >= 15.7f) return mx;
    return mx + tbl[(int)((mx - mn) * 500.0f)];
}

double hmmdp_forward_flogsum(
    const uint8_t* dsq, int32_t L,
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc,        // [Kp, W] log
    const double* xE, const double* xN, const double* xJ,
    const double* xC,
    int32_t M, int32_t Kp) {
    (void)Kp;
    const int W = M + 1;
    const float* tbl = flogsum_table();
    const float NEG = -1e30f;
    float* mrow = new float[W];
    float* irow = new float[W];
    float* drow = new float[W];
    float* nm = new float[W];
    float* ni = new float[W];
    float* nd = new float[W];
    for (int k = 0; k < W; k++) mrow[k] = irow[k] = drow[k] = NEG;
    float xNv = 0.0f, xBv = (float)xN[1], xJv = NEG, xCv = NEG;
    const float eJ0 = (float)xE[0], eJ1 = (float)xE[1];
    const float nloop = (float)xN[0], nmove = (float)xN[1];
    const float jloop = (float)xJ[0], jmove = (float)xJ[1];
    const float cloop = (float)xC[0], cmove = (float)xC[1];

    for (int i = 1; i <= L; i++) {
        const double* ms = msc + (size_t)dsq[i - 1] * W;
        const double* is = isc + (size_t)dsq[i - 1] * W;
        nm[0] = ni[0] = nd[0] = NEG;
        for (int k = 1; k <= M; k++) {
            // p7_GForward pairing: (MM, IM) then (BM, DM)
            float mm = mrow[k - 1] + (float)tMM[k - 1];
            float im = irow[k - 1] + (float)tIM[k - 1];
            float bm = xBv + (float)tBM[k - 1];
            float dm = drow[k - 1] + (float)tDM[k - 1];
            nm[k] = flogsum(tbl, flogsum(tbl, mm, im),
                            flogsum(tbl, bm, dm)) + (float)ms[k];
            ni[k] = k < M
                ? flogsum(tbl, mrow[k] + (float)tMI[k],
                          irow[k] + (float)tII[k]) + (float)is[k]
                : NEG;
            nd[k] = k >= 2
                ? flogsum(tbl, nm[k - 1] + (float)tMD[k - 1],
                          nd[k - 1] + (float)tDD[k - 1])
                : NEG;
        }
        float e = NEG;
        for (int k = 1; k <= M; k++) {
            e = flogsum(tbl, e, nm[k]);
            e = flogsum(tbl, e, nd[k]);
        }
        xJv = flogsum(tbl, xJv + jloop, e + eJ0);
        xCv = flogsum(tbl, xCv + cloop, e + eJ1);
        xNv = xNv + nloop;
        xBv = flogsum(tbl, xNv + nmove, xJv + jmove);
        std::swap(mrow, nm); std::swap(irow, ni); std::swap(drow, nd);
    }
    double score = (double)xCv + (double)cmove;
    delete[] mrow; delete[] irow; delete[] drow;
    delete[] nm; delete[] ni; delete[] nd;
    return score;
}

}  // extern "C"

extern "C" {

// Composition bias filter (p7_bg_FilterScore semantics, matching
// plan7/background.py Background.filter_score exactly): 2-state odds-space
// forward with conditional rescaling.  odds1[Kp] is the state-1 emission
// odds table (state 0 emits odds 1 everywhere); returns the log-odds
// score WITHOUT the null1 geometric length term.
double hmmdp_bias_filter(const uint8_t* dsq, int32_t L,
                         const double* odds1) {
    if (L <= 0) return 0.0;
    double p1 = (double)L / (double)(L + 1);
    double t00 = p1, t01 = 1.0 - p1;
    // state-1 dwell 50, entry pi=(0.999, 0.001): calibrated against the
    // full PF02826+RREFam golden tables (see Background.filter_score)
    const double t11 = 50.0 / 51.0, t10 = 1.0 / 51.0;
    double a0 = 0.999, a1 = 0.001 * odds1[dsq[0]];
    double logsc = 0.0;
    for (int32_t i = 1; i < L; i++) {
        double n0 = a0 * t00 + a1 * t10;
        double n1 = (a0 * t01 + a1 * t11) * odds1[dsq[i]];
        double s = n0 + n1;
        if (s > 0 && (s > 1e30 || s < 1e-30)) {
            n0 /= s; n1 /= s;
            logsc += log(s);
        }
        a0 = n0; a1 = n1;
    }
    return logsc + log(a0 + a1);
}

// Batched variant: one call per (profile, set-of-survivors) to keep
// ctypes overhead off the per-pair path.  codes [N, Lmax] row-major,
// lens [N]; writes logsc[N].
void hmmdp_bias_filter_batch(const uint8_t* codes, const int64_t* lens,
                             int32_t N, int32_t Lmax,
                             const double* odds1, double* out) {
    for (int32_t n = 0; n < N; n++) {
        out[n] = hmmdp_bias_filter(codes + (int64_t)n * Lmax,
                                   (int32_t)lens[n], odds1);
    }
}

// Indexed variant over a shared bucket: rows[j] selects rows of the full
// codes matrix, avoiding the fancy-index copy on the Python side.
void hmmdp_bias_filter_idx(const uint8_t* codes, const int64_t* lens,
                           const int64_t* rows, int32_t nrows,
                           int32_t Lmax, const double* odds1, double* out) {
    CallTimer call_timer;
    for (int32_t j = 0; j < nrows; j++) {
        int64_t r = rows[j];
        out[j] = hmmdp_bias_filter(codes + r * Lmax,
                                   (int32_t)lens[r], odds1);
    }
}

}  // extern "C"

extern "C" {

// Multihit local Viterbi score (log-space max-plus, float-exact
// semantics matching ops/reference.py viterbi_score).  Score-only: used
// as the host-side F2 gate for survivor pairs too sparse to justify a
// batched device Viterbi call.
static double viterbi_core(
    const uint8_t* dsq, int32_t L,
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc,
    const double* xE, const double* xN, const double* xJ, const double* xC,
    int32_t M, int32_t Kp) {
    const int W = M + 1;
    Arena::Mark amark = g_arena.mark();
    double* mrow = g_arena.alloc(W);
    double* irow = g_arena.alloc(W);
    double* drow = g_arena.alloc(W);
    double* nm = g_arena.alloc(W);
    double* ni = g_arena.alloc(W);
    double* nd = g_arena.alloc(W);
    for (int k = 0; k < W; k++) mrow[k] = irow[k] = drow[k] = NEGMASS;
    double xNs = 0.0, xBs = xN[1], xJs = NEGMASS, xCs = NEGMASS;
    for (int i = 1; i <= L; i++) {
        const double* ms = msc + (size_t)dsq[i - 1] * W;
        const double* is = isc + (size_t)dsq[i - 1] * W;
        nm[0] = ni[0] = nd[0] = NEGMASS;
        for (int k = 1; k <= M; k++) {
            double v = std::max(
                std::max(mrow[k - 1] + tMM[k - 1], irow[k - 1] + tIM[k - 1]),
                std::max(drow[k - 1] + tDM[k - 1], xBs + tBM[k - 1]));
            nm[k] = ms[k] + v;
        }
        for (int k = 1; k < M; k++)
            ni[k] = is[k] + std::max(mrow[k] + tMI[k], irow[k] + tII[k]);
        for (int k = std::max((int)M, 1); k < W; k++) ni[k] = NEGMASS;
        if (M >= 1) nd[1] = NEGMASS;
        for (int k = 2; k <= M; k++)
            nd[k] = std::max(nm[k - 1] + tMD[k - 1], nd[k - 1] + tDD[k - 1]);
        double e = NEGMASS;
        for (int k = 1; k <= M; k++) e = std::max(e, nm[k]);
        for (int k = 1; k <= M; k++) e = std::max(e, nd[k]);
        double nJ = std::max(xJs + xJ[0], e + xE[0]);
        double nC = std::max(xCs + xC[0], e + xE[1]);
        double nN = xNs + xN[0];
        double nB = std::max(nN + xN[1], nJ + xJ[1]);
        xNs = nN; xBs = nB; xJs = nJ; xCs = nC;
        std::swap(mrow, nm); std::swap(irow, ni); std::swap(drow, nd);
    }
    g_arena.release(amark);
    return xCs + xC[1];
}

double hmmdp_viterbi(
    const uint8_t* dsq, int32_t L,
    const double* tBM, const double* tMM, const double* tIM,
    const double* tDM, const double* tMD, const double* tDD,
    const double* tMI, const double* tII,
    const double* msc, const double* isc,
    const double* xE, const double* xN, const double* xJ, const double* xC,
    int32_t M, int32_t Kp) {
    CallTimer call_timer;
    return viterbi_core(dsq, L, tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII,
                        msc, isc, xE, xN, xJ, xC, M, Kp);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched postprocessing: many survivor pairs in one call
// ---------------------------------------------------------------------------
//
// One call finishes a batch of (profile, target) pairs with the GIL
// released for all of them: per pair, in order, the optional Viterbi F2
// gate, the domain definition with the pair's seed and Forward floor (the
// F3 bail-out), and each domain's alignment display (model, target,
// identity and posterior lines, the bytes of the sequential pipeline's
// _make_alignment_np).  The outputs are sized by what the pairs produce
// and kept in this thread's BatchOut until hmmdp_dd_batch_read copies
// them out, so one worker runs batch and read back to back.

namespace {

// row of the per-profile pointer table (ops/native.py BatchProfiles)
enum {
    BP_TBM, BP_TMM, BP_TIM, BP_TDM, BP_TMD, BP_TDD, BP_TMI, BP_TII,
    BP_MSC, BP_ISC, BP_ODDS_M, BP_ODDS_I, BP_CORE, BP_DEGW, BP_DEG_ONE,
    BP_SYM_U, BP_SYM_L, BP_SYM_UP, BP_CONS, BP_CONS_UP, BP_MPOS, BP_N
};
// row of the per-profile integer table
enum { BI_M, BI_K, BI_KP, BI_NULL2, BI_NCONS, BI_N };
// per-pair status
enum { DD_HIT = 0, DD_GATED_VIT = 1, DD_GATED_F3 = 2, DD_OVERFLOW = 3 };

template <typename T>
struct Grow {  // a grow-only uninitialised buffer
    T* p = nullptr;
    int64_t cap = 0;
    ~Grow() { delete[] p; }
    T* get(int64_t n) {
        if (n > cap) {
            delete[] p;
            cap = std::max<int64_t>(n, cap + cap / 2);
            p = new T[cap];
        }
        return p;
    }
};

struct BatchOut {
    std::vector<int32_t> status, pair_int;   // per pair; pair_int 5 each
    std::vector<double> pair_dbl;            // per pair: fwdsc, nexpected
    std::vector<int64_t> n2_off;             // per pair, -1: none
    std::vector<double> n2;                  // n2sc [L+1] of each hit pair
    std::vector<int32_t> dom_int;            // per domain 6
    std::vector<double> dom_dbl;             // per domain 3
    std::vector<int64_t> dom_text;           // per domain: offset, length
    std::vector<uint8_t> text;               // 4 lines of a domain's length
    // per-pair scratch of hmmdp_domaindef's buffers
    Grow<int32_t> s_dom_int; Grow<double> s_dom_dbl;
    Grow<int8_t> s_st; Grow<int32_t> s_k; Grow<int32_t> s_i;
    Grow<double> s_pp; Grow<int64_t> s_off; Grow<double> s_n2;
    void clear() {
        status.clear(); pair_int.clear(); pair_dbl.clear(); n2_off.clear();
        n2.clear(); dom_int.clear(); dom_dbl.clear(); dom_text.clear();
        text.clear();
    }
};
thread_local BatchOut t_batch;

// The display lines of one domain's trace [o0, o1), as the sequential
// pipeline's _make_alignment_np builds them: the trace cut to its first
// and last M state, then at its first state that is neither M, I nor D.
void display_lines(BatchOut& out, const int8_t* st, const int32_t* tk,
                   const int32_t* ti, const double* tp, int64_t o0,
                   int64_t o1, const uint8_t* dsq, const void* const* P,
                   int32_t ncons) {
    const uint8_t* sym_u = (const uint8_t*)P[BP_SYM_U];
    const uint8_t* sym_l = (const uint8_t*)P[BP_SYM_L];
    const uint8_t* sym_up = (const uint8_t*)P[BP_SYM_UP];
    const uint8_t* cons = (const uint8_t*)P[BP_CONS];
    const uint8_t* cons_up = (const uint8_t*)P[BP_CONS_UP];
    const uint8_t* mpos = (const uint8_t*)P[BP_MPOS];   // [Kp, ncons]
    int64_t z0 = -1, z1 = -1;
    for (int64_t z = o0; z < o1; z++)
        if (st[z] == 'M') { if (z0 < 0) z0 = z; z1 = z + 1; }
    if (z0 < 0) { z0 = o0; z1 = o1; }
    int64_t stop = z1;
    for (int64_t z = z0; z < z1; z++)
        if (st[z] != 'M' && st[z] != 'I' && st[z] != 'D') { stop = z; break; }
    const int64_t n = stop - z0;
    const int64_t off = (int64_t)out.text.size();
    out.dom_text.push_back(off);
    out.dom_text.push_back(n);
    out.text.resize(off + 4 * n);
    uint8_t* model = out.text.data() + off;
    uint8_t* target = model + n;
    uint8_t* mid = target + n;
    uint8_t* ppl = mid + n;
    for (int64_t q = 0; q < n; q++) {
        const int64_t z = z0 + q;
        const char s = (char)st[z];
        const bool isM = s == 'M', isI = s == 'I', isD = s == 'D';
        const int k = std::min<int64_t>(tk[z], ncons - 1);
        const uint8_t res = dsq[std::max<int32_t>(ti[z] - 1, 0)];
        const uint8_t mc = cons[k];
        model[q] = isI ? (uint8_t)'.' : mc;
        target[q] = isM ? sym_u[res] : isI ? sym_l[res] : (uint8_t)'-';
        const bool same = cons_up[k] == sym_up[res];
        const bool plus = mpos[(size_t)res * ncons + k] != 0;
        mid[q] = (isM && same) ? mc : (isM && plus) ? (uint8_t)'+'
                                                   : (uint8_t)' ';
        int64_t x = std::min<int64_t>((int64_t)std::rint(tp[z] * 10.0), 10);
        uint8_t c = x >= 10 ? (uint8_t)'*' : (uint8_t)('0' + x);
        ppl[q] = isD ? (uint8_t)'.' : c;
    }
}

}  // namespace

extern "C" {

// npairs pairs.  pair_i [npairs, 7]: the pair's row of the profile
// tables prof_ptr [nprof, BP_N] and prof_int [nprof, BI_N], the address
// of its L residues, L, its seed, its buffers' sizes max_dom and max_tr
// (past which it overflows), and whether the Viterbi gate runs.  pair_d
// [npairs, 4]: the Forward floor (finite), the Viterbi floor and the
// length model's log loop and move; vit_xe is log(0.5).  sizes_out[4]:
// pairs, domains, null2 scores, text bytes.  Returns the number of pairs
// that ran the domain definition.
int32_t hmmdp_domaindef_batch(
    int32_t npairs, const int64_t* pair_i, const double* pair_d,
    double vit_xe, const uint64_t* prof_ptr, const int32_t* prof_int,
    int32_t nsamples, double rt1, double rt2, double rt3,
    int64_t* sizes_out) {
    CallTimer call_timer;
    BatchOut& out = t_batch;
    out.clear();
    int32_t ndd = 0;
    double scal[6];
    const double xE[2] = {vit_xe, vit_xe};
    for (int32_t p = 0; p < npairs; p++) {
        const int64_t* pi = pair_i + 7 * (size_t)p;
        const double* pdv = pair_d + 4 * (size_t)p;
        const void* const* P = reinterpret_cast<const void* const*>(
            prof_ptr + (size_t)pi[0] * BP_N);
        const int32_t* I = prof_int + (size_t)pi[0] * BI_N;
        const int32_t M = I[BI_M], K = I[BI_K], Kp = I[BI_KP];
        const uint8_t* dsq = reinterpret_cast<const uint8_t*>(pi[1]);
        const int32_t L = (int32_t)pi[2];
        const double fwd_min = pdv[0];
        const double* const* D = reinterpret_cast<const double* const*>(P);
        int32_t st = DD_HIT;
        double pd[2] = {0.0, 0.0};
        int32_t pi5[5] = {0, 0, 0, 0, 0};
        int64_t n2o = -1;
        if (pi[6]) {
            const double* x = pdv + 2;
            double v = viterbi_core(
                dsq, L, D[BP_TBM], D[BP_TMM], D[BP_TIM], D[BP_TDM],
                D[BP_TMD], D[BP_TDD], D[BP_TMI], D[BP_TII], D[BP_MSC],
                D[BP_ISC], xE, x, x, x, M, Kp);
            if (v < pdv[1]) st = DD_GATED_VIT;
        }
        if (st == DD_HIT) {
            ndd++;
            const int32_t max_dom = (int32_t)pi[4];
            const int64_t max_tr = pi[5];
            int32_t* di = out.s_dom_int.get((int64_t)max_dom * 6);
            double* dd = out.s_dom_dbl.get((int64_t)max_dom * 3);
            int8_t* tst = out.s_st.get(max_tr);
            int32_t* tk = out.s_k.get(max_tr);
            int32_t* ti = out.s_i.get(max_tr);
            double* tp = out.s_pp.get(max_tr);
            int64_t* toff = out.s_off.get(max_dom + 1);
            double* n2sc = out.s_n2.get(L + 1);
            std::fill(n2sc, n2sc + L + 1, 0.0);
            int32_t ndom = domaindef_core(
                dsq, L, D[BP_TBM], D[BP_TMM], D[BP_TIM], D[BP_TDM],
                D[BP_TMD], D[BP_TDD], D[BP_TMI], D[BP_TII], D[BP_MSC],
                D[BP_ISC], M, K, Kp, D[BP_ODDS_M], D[BP_ODDS_I],
                D[BP_DEGW], (const uint8_t*)P[BP_DEG_ONE], I[BI_NULL2],
                (uint64_t)pi[3] & 0x7FFFFFFFFFFFFFFFULL, nsamples, rt1, rt2,
                rt3, fwd_min, scal, n2sc, di, dd, max_dom, tst, tk, ti, tp,
                toff, max_tr, P[BP_CORE], nullptr, 0.0, 0.0);
            if (ndom < 0) {
                st = DD_OVERFLOW;
            } else if (scal[0] < fwd_min) {
                st = DD_GATED_F3;
                pd[0] = scal[0];
            } else {
                pd[0] = scal[0]; pd[1] = scal[1];
                for (int q = 0; q < 4; q++) pi5[q] = (int32_t)scal[2 + q];
                pi5[4] = ndom;
                n2o = (int64_t)out.n2.size();
                out.n2.insert(out.n2.end(), n2sc, n2sc + L + 1);
                for (int32_t d = 0; d < ndom; d++) {
                    out.dom_int.insert(out.dom_int.end(), di + 6 * d,
                                       di + 6 * d + 6);
                    out.dom_dbl.insert(out.dom_dbl.end(), dd + 3 * d,
                                       dd + 3 * d + 3);
                    display_lines(out, tst, tk, ti, tp, toff[d], toff[d + 1],
                                  dsq, P, I[BI_NCONS]);
                }
            }
        }
        out.status.push_back(st);
        out.pair_dbl.insert(out.pair_dbl.end(), pd, pd + 2);
        out.pair_int.insert(out.pair_int.end(), pi5, pi5 + 5);
        out.n2_off.push_back(n2o);
    }
    sizes_out[0] = npairs;
    sizes_out[1] = (int64_t)out.dom_dbl.size() / 3;
    sizes_out[2] = (int64_t)out.n2.size();
    sizes_out[3] = (int64_t)out.text.size();
    return ndd;
}

// Copy this thread's last batch out.  ints: status [N], pair_int
// [N, 5], n2_off [N], dom_int [D, 6], dom_text [D, 2]; dbls: pair_dbl
// [N, 2], dom_dbl [D, 3], the null2 scores; text: the display lines.
void hmmdp_dd_batch_read(int64_t* ints, double* dbls, uint8_t* text) {
    const BatchOut& out = t_batch;
    for (const auto* v : {&out.status, &out.pair_int})
        ints = std::copy(v->begin(), v->end(), ints);
    ints = std::copy(out.n2_off.begin(), out.n2_off.end(), ints);
    ints = std::copy(out.dom_int.begin(), out.dom_int.end(), ints);
    std::copy(out.dom_text.begin(), out.dom_text.end(), ints);
    for (const auto* v : {&out.pair_dbl, &out.dom_dbl, &out.n2})
        dbls = std::copy(v->begin(), v->end(), dbls);
    std::copy(out.text.begin(), out.text.end(), text);
}

}  // extern "C"
