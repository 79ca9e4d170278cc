// Native host-side runtime kernels for lanczosplusplus_tpu.
//
// The accelerator executes the numeric hot path (SpMV/GEMM/Lanczos); these are
// the *host* hot loops that prepare device data: basis enumeration,
// combinadic ranking, and one-spin hopping ELL assembly.  They mirror
// the vectorized numpy implementations in core/ (which remain the
// fallback when this library is not built) and the reference's
// bit-trick enumeration (reference:
// src/Models/HubbardOneOrbital/BasisOneSpin.h:52-81).
//
// Build: make -C native   (produces liblanczos_native.so; loaded via
// ctypes by lanczosplusplus_tpu/native.py)

#include <cstdint>
#include <cstddef>
#include <cstring>

namespace {

inline int parity_below(uint64_t w, int i)
{
    const uint64_t mask = (i >= 64) ? ~0ull : ((1ull << i) - 1ull);
    return __builtin_parityll(w & mask) ? -1 : 1;
}

inline int64_t colex_rank(uint64_t x, const int64_t* comb,
                          int comb_stride)
{
    int64_t rank = 0;
    int c = 0, b = 0;
    while (x) {
        if (x & 1ull) {
            ++c;
            rank += comb[(long)b * comb_stride + c];
        }
        x >>= 1;
        ++b;
    }
    return rank;
}

} // namespace

extern "C" {

// Enumerate all C(nsite, npart) words in colex order into `out`
// (caller allocates the full count).  Returns the count.
long lpp_enumerate_combinations(int nsite, int npart, uint64_t* out)
{
    if (npart == 0) {
        out[0] = 0;
        return 1;
    }
    long hilbert = 1;
    {
        long n = nsite;
        for (long m = 1; m <= npart; --n, ++m)
            hilbert = hilbert * n / m;
    }
    uint64_t ket = (1ull << npart) - 1ull;
    for (long i = 0; i < hilbert; ++i) {
        out[i] = ket;
        uint64_t x = ket;
        int n = 0, m = 0;
        while ((x & 3ull) != 1ull) {
            m += (int)(x & 1ull);
            ++n;
            x >>= 1;
        }
        ket = ((x + 1ull) << n) ^ ((1ull << m) - 1ull);
    }
    return hilbert;
}

// Colex rank of each word (vector perfectIndex).
void lpp_rank_combinations(const uint64_t* words, long nwords,
                           const int64_t* comb, int comb_stride,
                           int64_t* out)
{
    for (long w = 0; w < nwords; ++w)
        out[w] = colex_rank(words[w], comb, comb_stride);
}

// One-spin hopping ELL assembly: for each directed bond
// (bi[k] -> bj[k]) with amplitude t[k], rows whose bit bi is occupied
// and bj empty hop with amplitude t * doSign(ket, bi) * doSign(ket ^
// bit_bi, bj); target column = colex rank of the flipped word
// (matches core/sparse.py one_spin_ell and HubbardHelper.h:191-243).
void lpp_one_spin_hop_ell(const uint64_t* words, long nwords,
                          const int* bi, const int* bj, const double* t,
                          int nbonds, const int64_t* comb,
                          int comb_stride, int32_t* cols, double* vals)
{
    for (long w = 0; w < nwords; ++w) {
        const uint64_t ket = words[w];
        for (int k = 0; k < nbonds; ++k) {
            const int i = bi[k];
            const int j = bj[k];
            const uint64_t maski = 1ull << i;
            const uint64_t maskj = 1ull << j;
            int32_t col = (int32_t)w;
            double val = 0.0;
            if ((ket & maski) && !(ket & maskj)) {
                int sign = parity_below(ket, i);
                const uint64_t mid = ket ^ maski;
                sign *= parity_below(mid, j);
                col = (int32_t)colex_rank(mid ^ maskj, comb, comb_stride);
                val = t[k] * sign;
            }
            cols[w * nbonds + k] = col;
            vals[w * nbonds + k] = val;
        }
    }
}

// Sector-scatter-plan bucketing (parallel/scatter_plan.py): one pass
// counts the (src device, dst device) bucket sizes, a second fills the
// padded (ndev, ndev, maxcount) send/receive tables.  amp is copied
// opaquely (itemsize bytes per entry) so float64/complex128 maps share
// one entry point.  Replaces a per-nonzero Python loop that cost
// minutes at 1e7-dim operator maps on this host.
void lpp_scatter_plan_count(const int64_t* tgt, long n, long s_src,
                            long s_dst, int ndev, int64_t* counts)
{
    for (long i = 0; i < n; ++i) {
        const int64_t t = tgt[i];
        if (t < 0) continue;
        const long d = i / s_src, o = t / s_dst;
        ++counts[d * ndev + o];
    }
}

void lpp_scatter_plan_fill(const int64_t* tgt, long n, long s_src,
                           long s_dst, int ndev, long maxcount,
                           const char* amp, long itemsize,
                           int32_t* send_src, char* send_amp,
                           int32_t* dst_idx, int64_t* counts)
{
    // counts re-used as running cursors; caller re-zeroes it
    for (long i = 0; i < n; ++i) {
        const int64_t t = tgt[i];
        if (t < 0) continue;
        const long d = i / s_src, o = t / s_dst;
        const long pos = counts[d * ndev + o]++;
        const long slot = (d * ndev + o) * maxcount + pos;
        send_src[slot] = (int32_t)(i - d * s_src);
        dst_idx[(o * ndev + d) * maxcount + pos] =
            (int32_t)(t - o * s_dst);
        memcpy(send_amp + slot * itemsize, amp + i * itemsize,
               (size_t)itemsize);
    }
}

} // extern "C"
