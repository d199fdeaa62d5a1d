// aniso_host: native host-side runtime for aniso_tpu.
//
// Equivalent of the reference's C++/OpenMP cache-assembly
// runtime (reference KernelFactory.cpp:67-190 lineIntegral +
// :550-788 cache passes): the sigma-dependent attenuation line integrals
// E(p, q) that feed the device caches are embarrassingly parallel scalar
// work, best done on the host CPU in float64 with OpenMP while the device
// holds the compiled matvec.  Exposed through a plain C ABI for ctypes.
//
// The quadrature is EXACTLY the one in aniso_tpu/ops/attenuation.py
// (segment split at gridline crossings, per-cell Gauss rule on the
// per-square normalized Legendre expansion); CPU code may branch, so the
// implementation is a direct scalar loop instead of the branch-free
// tensor recast used on device.
//
// Build: see csrc/Makefile (g++ -O3 -fopenmp -shared).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// P_0..P_{deg-1} at x via the Legendre recurrence.
inline void legendre_all(int deg, double x, double* out) {
    out[0] = 1.0;
    if (deg > 1) out[1] = x;
    for (int n = 2; n < deg; ++n) {
        out[n] = ((2.0 * n - 1.0) * x * out[n - 1] -
                  (n - 1.0) * out[n - 2]) / n;
    }
}

struct Tables {
    int sz;
    int deg;
    const double* gauss_x;   // (deg) on [-1, 1]
    const double* gauss_w;   // (deg)
    const double* norms;     // (deg*deg)
    const double* coeffs;    // (sz*sz, deg*deg) row-major, cell (i, j) at i*sz+j
    int compat_global;       // evaluate basis at global coords (reference quirk)
};

// sigma_hat at one point inside cell (i, j), local coords (ex, ey) in [-1,1].
inline double eval_sigma(const Tables& T, int i, int j, double ex, double ey) {
    const int deg = T.deg;
    double px[64], py[64];
    legendre_all(deg, ex, px);
    legendre_all(deg, ey, py);
    const double* c = T.coeffs + (size_t)(i * T.sz + j) * deg * deg;
    double acc = 0.0;
    for (int a = 0; a < deg; ++a) {
        double pa = px[a];
        const double* row = c + a * deg;
        const double* nrm = T.norms + a * deg;
        for (int b = 0; b < deg; ++b) {
            acc += row[b] * pa * py[b] / nrm[b];
        }
    }
    return acc;
}

// Exact attenuation integral along p0 -> p1 (physical coords in [0,1]^2).
double line_integral(const Tables& T, double x0, double y0,
                     double x1, double y1, std::vector<double>& ts) {
    const int sz = T.sz;
    const int deg = T.deg;
    const double dx = x1 - x0, dy = y1 - y0;
    const double len = std::sqrt(dx * dx + dy * dy);
    if (len == 0.0) return 0.0;

    ts.clear();
    ts.push_back(0.0);
    ts.push_back(1.0);
    // gridline crossings per axis (reference lineIntegral's 9-case split,
    // KernelFactory.cpp:67-166, reduced to crossing enumeration)
    for (int axis = 0; axis < 2; ++axis) {
        double a0 = axis ? y0 : x0;
        double a1 = axis ? y1 : x1;
        if (a0 == a1) continue;
        double lo = std::min(a0, a1), hi = std::max(a0, a1);
        long k_lo = (long)std::floor(lo * sz);
        long k_hi = (long)std::floor(hi * sz);
        for (long k = k_lo + 1; k <= k_hi; ++k) {
            double t = ((double)k / sz - a0) / (a1 - a0);
            if (t > 0.0 && t < 1.0) ts.push_back(t);
        }
    }
    std::sort(ts.begin(), ts.end());

    double E = 0.0;
    for (size_t s = 0; s + 1 < ts.size(); ++s) {
        double ta = ts[s], tb = ts[s + 1];
        double h = tb - ta;
        if (h <= 0.0) continue;
        double tm = 0.5 * (ta + tb);
        double xm = x0 + tm * dx, ym = y0 + tm * dy;
        int i = std::min(std::max((int)std::floor(xm * sz), 0), sz - 1);
        int j = std::min(std::max((int)std::floor(ym * sz), 0), sz - 1);
        double seg = 0.0;
        for (int g = 0; g < deg; ++g) {
            double tg = tm + 0.5 * h * T.gauss_x[g];
            double xg = x0 + tg * dx, yg = y0 + tg * dy;
            double ex, ey;
            if (T.compat_global) {
                ex = xg; ey = yg;
            } else {
                ex = 2.0 * (xg * sz - i) - 1.0;
                ey = 2.0 * (yg * sz - j) - 1.0;
            }
            seg += T.gauss_w[g] * eval_sigma(T, i, j, ex, ey);
        }
        E += seg * len * h * 0.5;
    }
    return E;
}

}  // namespace

extern "C" {

// E[k] = int_{p0_k -> p1_k} sigma_hat.  p0/p1: (n, 2) row-major physical.
void aniso_attenuation_batch(
    int sz, int deg,
    const double* gauss_x, const double* gauss_w, const double* norms,
    const double* coeffs, int compat_global,
    const double* p0, const double* p1, long n, double* out) {
    Tables T{sz, deg, gauss_x, gauss_w, norms, coeffs, compat_global};
#pragma omp parallel
    {
        std::vector<double> ts;
        ts.reserve(2 * sz + 4);
#pragma omp for schedule(static)
        for (long k = 0; k < n; ++k) {
            out[k] = line_integral(T, p0[2 * k], p0[2 * k + 1],
                                   p1[2 * k], p1[2 * k + 1], ts);
        }
    }
}

// Dense smooth-kernel row block: for targets t in [row0, row0+nrows) and all
// n sources, out[t - row0, s] = (expm1(-E(s, t)) cos(m * theta(s, t)) / r)
// * w[s], with the m = 0 diagonal set to sigma_hat(node_t) * w[t]
// (reference KernelFactory.cpp:240-267 makeKernels imagParts).
void aniso_smooth_rows(
    int sz, int deg,
    const double* gauss_x, const double* gauss_w, const double* norms,
    const double* coeffs, int compat_global,
    const double* nodes,        // (n, 2) all node coords
    const double* weights,      // (n) global quadrature weights
    int mode, long n, long row0, long nrows, double* out) {
    Tables T{sz, deg, gauss_x, gauss_w, norms, coeffs, compat_global};
#pragma omp parallel
    {
        std::vector<double> ts;
        ts.reserve(2 * sz + 4);
#pragma omp for schedule(dynamic, 8)
        for (long r = 0; r < nrows; ++r) {
            long t = row0 + r;
            double tx = nodes[2 * t], ty = nodes[2 * t + 1];
            double* row = out + (size_t)r * n;
            for (long s = 0; s < n; ++s) {
                double sx = nodes[2 * s], sy = nodes[2 * s + 1];
                double ddx = sx - tx, ddy = sy - ty;
                double rr = std::sqrt(ddx * ddx + ddy * ddy);
                double v;
                if (rr == 0.0) {
                    if (mode == 0) {
                        int i = std::min(std::max((int)std::floor(tx * sz), 0), sz - 1);
                        int j = std::min(std::max((int)std::floor(ty * sz), 0), sz - 1);
                        double ex, ey;
                        if (compat_global) { ex = tx; ey = ty; }
                        else {
                            ex = 2.0 * (tx * sz - i) - 1.0;
                            ey = 2.0 * (ty * sz - j) - 1.0;
                        }
                        v = eval_sigma(T, i, j, ex, ey);
                    } else {
                        v = 0.0;
                    }
                } else {
                    double E = line_integral(T, sx, sy, tx, ty, ts);
                    double ang = std::atan2(ddy, ddx);
                    v = std::expm1(-E) * std::cos(mode * ang) / rr;
                }
                row[s] = v * weights[s];
            }
        }
    }
}

// 32-significant-digit CSV write, one value per line (matlab_io.h:24-33).
int aniso_write_csv(const char* path, const double* x, long n) {
    FILE* f = std::fopen(path, "w");
    if (!f) return -1;
    for (long i = 0; i < n; ++i) std::fprintf(f, "%.32g\n", x[i]);
    std::fclose(f);
    return 0;
}

// CSV read of up to n doubles (one per line); returns count read or -1.
long aniso_read_csv(const char* path, double* x, long n) {
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    long i = 0;
    while (i < n && std::fscanf(f, "%lf", &x[i]) == 1) ++i;
    std::fclose(f);
    return i;
}

int aniso_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
