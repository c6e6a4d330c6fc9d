// The natural cubic spline's second derivatives, one batched Thomas solve, in float64.
//
// Replaces no TPU kernel. The JAX package builds its splines in plain jnp
// (cosmoprimo_tpu/ops/spline.py): a dense LU of the (n-2, n-2) matrix for knots
// shared by every column, log-depth scans for knots per row. On this card the
// port's copies of those two ran at 1-2% of what device memory allows: the
// dense LU does O(n^2) work a column for an O(n) system (cuBLAS trsm), the
// scans ten doubling steps of (rows, n) temporaries. This kernel solves the
// same systems in one sequential pass a system.
//
// Contract, for each system (a row of v along its knot axis) with knots
// x_0 < ... < x_{n-1}, h_i = x_{i+1} - x_i and n >= 4:
//   out_0 = out_{n-1} = 0, and for 1 <= j <= n-2
//   h_{j-1}/6 out_{j-1} + (h_{j-1} + h_j)/3 out_j + h_j/6 out_{j+1} = r_j
// with r_j = (f_{j+1} - f_j)/h_j - (f_j - f_{j-1})/h_{j-1} computed from the
// values v = f (n per system), or r_j = v_{j-1} given (n - 2 per system: the
// tangent and the adjoint solves; the matrix is symmetric, so both are this
// solve). The matrix is strictly diagonally dominant, so elimination without
// pivoting is exact and stable: c_j = du_j / (d_j - dl_j c_{j-1}),
// g_j = (r_j - dl_j g_{j-1}) / (d_j - dl_j c_{j-1}), then
// out_j = g_j - c_j out_{j+1}. A non-finite value stays in its own system.
//
// Layouts. A system is (a, b) on two batch axes; every array is read through
// its own element strides (knot axis, a, b), so transposed, moved and expanded
// views are taken as they are, with no copy. Knots are shared (both batch
// strides of x 0) or per system.
// - Shared knots: c_j, 1/(d_j - dl_j c_{j-1}), dl_j/(...) and 1/h_j depend on
//   the knots alone: one warp computes them once into `fac` (4 n doubles),
//   and each system runs only its right-hand side's recurrence,
//   g_j = r_j inv_j - e_j g_{j-1}, one FMA in its dependency chain a knot.
// - Knots per system: each thread eliminates its own system and keeps c_j in
//   `scratch` (n doubles a system) for the back substitution.
// - Knot axis strided, systems adjacent (a table (n, columns)): one thread a
//   system, reading v[j] straight from device memory; the 32 threads of a
//   warp read 32 neighbouring addresses at every knot.
// - Knot axis contiguous (rows (systems, n)): a block of 64 systems stages
//   tiles of 16 knots through shared memory, loaded and stored 128 bytes a
//   row segment, and each thread walks its row in the tile (padded by one
//   double, so the walk is free of bank conflicts). The next tile's loads
//   are in flight during the walk; the forward pass's last tile stays in
//   shared memory for the back substitution. On rows the one-thread kernel
//   above is 2.0-3.7x slower (a warp's 32 loads touch 32 lines a knot); on
//   columns this one is 1.14x slower than it (PERF.md, the numbers).
//
// What bounds it on an H100 SXM. A build reads v once and writes out twice
// and reads it once (forward g, then the back substitution), with the knots
// and c_j besides when they are per system: at (57 344 systems, 1024 knots)
// with shared knots, 0.47 GB of values and 0.47 GB of output, a bound of
// 0.28 ms at 3.35 TB/s (its least bytes, v read and out written once). The
// arithmetic is a few f64 operations a knot, far below the f64 rate, so
// device memory bounds it, and the latency of its loads: one thread a
// system leaves 14 warps an SM at 57 344 systems, so each thread keeps 8 to
// 16 loads in flight (unrolled, or a tile ahead). Measured (NVIDIA H100 80GB
// HBM3, 700 W): 0.9-1.1 ms at that shape, shared knots; 1.1 ms for 700
// knots per system. PERF.md keeps the numbers of each run.

#include <cuda_runtime.h>

namespace {

struct Axes {
    long long k, a, b;   // element strides: the knot axis, the outer and the inner batch axis
};

constexpr int kDirectThreads = 128;
constexpr int kTileSystems = 64;
constexpr int kTileKnots = 16;

// 2x2 matrices as (m00, m01, m10, m11), scaled by a power of two (exact) so
// that the largest entry lies in [1, 2): only their ratios are used.
struct Mat {
    double m00, m01, m10, m11;
};

__device__ Mat normalised(Mat a) {
    const double big = fmax(fmax(fabs(a.m00), fabs(a.m01)), fmax(fabs(a.m10), fabs(a.m11)));
    if (big == 0.0 || !isfinite(big)) return a;
    const int e = ilogb(big);
    return {scalbn(a.m00, -e), scalbn(a.m01, -e), scalbn(a.m10, -e), scalbn(a.m11, -e)};
}

__device__ Mat times(Mat a, Mat b) {   // a @ b
    return normalised({a.m00 * b.m00 + a.m01 * b.m10, a.m00 * b.m01 + a.m01 * b.m11,
                       a.m10 * b.m00 + a.m11 * b.m10, a.m10 * b.m01 + a.m11 * b.m11});
}

// The factors of knots shared by every system, into fac (4 n doubles):
// fac[i] = 1/h_i, and for 1 <= j <= n-2 fac[n + j] = inv_j = 1/(d_j - dl_j c_{j-1}),
// fac[2n + j] = dl_j inv_j, fac[3n + j] = c_j = du_j inv_j. One warp: the
// recurrence c_j = du_j / (d_j - dl_j c_{j-1}) is the Mobius map of the matrix
// [[0, du_j], [-dl_j, d_j]] on (c, 1); each lane multiplies the matrices of its
// chunk of rows, a scan of the lanes' products (warp shuffles) gives each
// chunk its first c_{j-1}, and each lane then runs its own rows.
__global__ void __launch_bounds__(32) spline_factors_kernel(const double* __restrict__ x, long long xk, int n,
                                                             double* __restrict__ fac) {
    const int lane = threadIdx.x;
    for (int i = lane; i < n - 1; i += 32) fac[i] = 1.0 / (x[(long long)(i + 1) * xk] - x[(long long)i * xk]);
    const int per = (n - 2 + 31) / 32;
    const int lo = 1 + lane * per, hi = min(lo + per, n - 1);
    Mat a{1.0, 0.0, 0.0, 1.0};
    for (int j = lo; j < hi; ++j) {
        const double h0 = x[(long long)j * xk] - x[(long long)(j - 1) * xk];
        const double h1 = x[(long long)(j + 1) * xk] - x[(long long)j * xk];
        a = times({0.0, h1 / 6.0, -h0 / 6.0, (h0 + h1) / 3.0}, a);
    }
    for (int off = 1; off < 32; off *= 2) {   // inclusive scan, the later lanes' products on the left
        const Mat b{__shfl_up_sync(0xffffffffu, a.m00, off), __shfl_up_sync(0xffffffffu, a.m01, off),
                    __shfl_up_sync(0xffffffffu, a.m10, off), __shfl_up_sync(0xffffffffu, a.m11, off)};
        if (lane >= off) a = times(a, b);
    }
    const double p = __shfl_up_sync(0xffffffffu, a.m01, 1), q = __shfl_up_sync(0xffffffffu, a.m11, 1);
    double c = lane == 0 ? 0.0 : p / q;   // c_{lo-1}: the earlier lanes' product on (0, 1)
    for (int j = lo; j < hi; ++j) {
        const double h0 = x[(long long)j * xk] - x[(long long)(j - 1) * xk];
        const double h1 = x[(long long)(j + 1) * xk] - x[(long long)j * xk];
        const double dl = h0 / 6.0;
        const double inv = 1.0 / ((h0 + h1) / 3.0 - dl * c);
        c = h1 / 6.0 * inv;
        fac[n + j] = inv;
        fac[2 * n + j] = dl * inv;
        fac[3 * n + j] = c;
    }
}

// One system's forward elimination, a row at a time.
template <bool SHARED, bool GIVEN>
struct Elimination {
    const double* fac;
    int n;
    double x1 = 0.0, h0 = 0.0;   // knots per system: x_j and h_{j-1}
    double f1 = 0.0, s0 = 0.0;   // values: f_j and the slope of cell j-1
    double g = 0.0, c = 0.0;     // g_{j-1} and c_{j-1}

    __device__ Elimination(const double* fac_, int n_) : fac(fac_), n(n_) {}

    // at j = 0: the first two knots (per system) and values
    __device__ void start(double x0, double x1_, double f0, double f1_) {
        if (!SHARED) {
            x1 = x1_;
            h0 = x1_ - x0;
        }
        if (!GIVEN) {
            f1 = f1_;
            s0 = SHARED ? (f1_ - f0) * fac[0] : (f1_ - f0) / h0;
        }
    }

    // row j (1 <= j <= n-2) from v = f_{j+1} (values) or r_j (given) and
    // xn = x_{j+1} (knots per system); returns g_j and leaves c_j in c
    __device__ double row(int j, double v, double xn) {
        double inv, e, ih1 = 0.0, h1 = 0.0;
        if (SHARED) {
            ih1 = fac[j];
            inv = fac[n + j];
            e = fac[2 * n + j];
            c = fac[3 * n + j];
        } else {
            h1 = xn - x1;
            const double dl = h0 / 6.0;
            inv = 1.0 / ((h0 + h1) / 3.0 - dl * c);
            e = dl * inv;
            c = h1 / 6.0 * inv;
        }
        double r = v;
        if (!GIVEN) {
            const double s1 = SHARED ? (v - f1) * ih1 : (v - f1) / h1;
            r = s1 - s0;
            s0 = s1;
            f1 = v;
        }
        if (!SHARED) {
            x1 = xn;
            h0 = h1;
        }
        g = r * inv - e * g;
        return g;
    }
};

// One thread a system, every array read straight from device memory.
template <bool SHARED, bool GIVEN>
__global__ void __launch_bounds__(kDirectThreads)
spline_direct_kernel(const double* __restrict__ x, Axes xs, const double* __restrict__ v, Axes vs,
                     double* __restrict__ out, Axes os, const double* __restrict__ fac,
                     double* __restrict__ scratch, int n, long long na, long long nb) {
    const long long systems = na * nb;
    const long long s = (long long)blockIdx.x * kDirectThreads + threadIdx.x;
    if (s >= systems) return;
    const long long a = s / nb, b = s - a * nb;
    const double* xp = x + a * xs.a + b * xs.b;
    const double* vp = v + a * vs.a + b * vs.b;
    double* op = out + a * os.a + b * os.b;
    Elimination<SHARED, GIVEN> el(fac, n);
    el.start(SHARED ? 0.0 : xp[0], SHARED ? 0.0 : xp[xs.k], GIVEN ? 0.0 : vp[0], GIVEN ? 0.0 : vp[vs.k]);
    op[0] = 0.0;
    constexpr int U = SHARED ? 8 : 4;   // loads in flight; per-system knots spill at 8
#pragma unroll U
    for (int j = 1; j < n - 1; ++j) {
        const double vj = vp[(long long)(GIVEN ? j - 1 : j + 1) * vs.k];
        const double xn = SHARED ? 0.0 : xp[(long long)(j + 1) * xs.k];
        op[(long long)j * os.k] = el.row(j, vj, xn);
        if (!SHARED) scratch[(long long)j * systems + s] = el.c;
    }
    op[(long long)(n - 1) * os.k] = 0.0;
    double m = 0.0;
#pragma unroll U
    for (int j = n - 2; j >= 1; --j) {
        const double c = SHARED ? fac[3 * n + j] : scratch[(long long)j * systems + s];
        m = op[(long long)j * os.k] - c * m;
        op[(long long)j * os.k] = m;
    }
}

// A block of kTileSystems systems, the knot axis staged through shared
// memory in tiles of kTileKnots knots. Element (r, k) of tile T is knot
// j = T K + k of the block's system r: its value v_{j+1} (values) or r_j
// (given) and its knot x_{j+1}; after the walk, g_j and c_j in place. A
// thread a system leaves few warps on an SM, so each tile's loads are issued
// into registers before the walk of the tile before it (and, in the back
// substitution, after it), and wait for nothing but that walk.
// With shared knots the walk keeps no knots: 8 blocks an SM (at most 128
// registers a thread) run it faster; with knots per system that would spill.
template <bool SHARED, bool GIVEN>
__global__ void __launch_bounds__(kTileSystems, SHARED ? 8 : 1)
spline_tiled_kernel(const double* __restrict__ x, Axes xs, const double* __restrict__ v, Axes vs,
                    double* __restrict__ out, Axes os, const double* __restrict__ fac,
                    double* __restrict__ scratch, int n, long long na, long long nb) {
    constexpr int S = kTileSystems, K = kTileKnots;
    __shared__ double tv[S][K + 1];
    __shared__ double tx[SHARED ? 1 : S][K + 1];
    __shared__ long long xbase[S], vbase[S], obase[S];
    const int t = threadIdx.x;
    const long long systems = na * nb;
    const long long s0 = (long long)blockIdx.x * S;
    const int rows = (int)(systems - s0 < S ? systems - s0 : S);
    if (t < rows) {
        const long long s = s0 + t, a = s / nb, b = s - a * nb;
        xbase[t] = a * xs.a + b * xs.b;
        vbase[t] = a * vs.a + b * vs.b;
        obase[t] = a * os.a + b * os.b;
    }
    __syncthreads();
    const bool live = t < rows;
    Elimination<SHARED, GIVEN> el(fac, n);
    if (live) {
        el.start(SHARED ? 0.0 : x[xbase[t]], SHARED ? 0.0 : x[xbase[t] + xs.k], GIVEN ? 0.0 : v[vbase[t]],
                 GIVEN ? 0.0 : v[vbase[t] + vs.k]);
    }
    const int tiles = (n + K - 1) / K;
    const int nv = GIVEN ? n - 2 : n;
    const int shift = GIVEN ? -1 : 1;
    // this thread's K elements of a tile: element i is row (i S + t) / K, knot (i S + t) % K
    double pv[K], px[SHARED ? 1 : K];
    auto fetch = [&](int T) {   // the forward pass's inputs of tile T
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const int r = (i * S + t) / K, k = (i * S + t) % K;
            const int iv = T * K + k + shift, ix = T * K + k + 1;
            pv[i] = (r < rows && iv >= 0 && iv < nv) ? v[vbase[r] + (long long)iv * vs.k] : 0.0;
            if constexpr (!SHARED) px[i] = (r < rows && ix < n) ? x[xbase[r] + (long long)ix * xs.k] : 0.0;
        }
    };
    auto fetch_back = [&](int T) {   // the back substitution's inputs of tile T: g_j and c_j
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const int r = (i * S + t) / K, k = (i * S + t) % K, j = T * K + k;
            pv[i] = (r < rows && j < n) ? out[obase[r] + (long long)j * os.k] : 0.0;
            if constexpr (!SHARED) px[i] = (r < rows && j < n) ? scratch[(s0 + r) * n + j] : 0.0;
        }
    };
    auto stage = [&]() {
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const int r = (i * S + t) / K, k = (i * S + t) % K;
            tv[r][k] = pv[i];
            if constexpr (!SHARED) tx[r][k] = px[i];
        }
    };
    auto store = [&](int T, bool with_c) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const int r = (i * S + t) / K, k = (i * S + t) % K, j = T * K + k;
            if (r < rows && j < n) {
                out[obase[r] + (long long)j * os.k] = tv[r][k];
                if constexpr (!SHARED) {
                    if (with_c) scratch[(s0 + r) * n + j] = tx[r][k];
                }
            }
        }
    };
    fetch(0);
    for (int T = 0; T < tiles; ++T) {
        stage();
        __syncthreads();
        if (T + 1 < tiles) fetch(T + 1);
        if (live) {
#pragma unroll 4
            for (int k = 0; k < K; ++k) {
                const int j = T * K + k;
                double g = 0.0;
                if (j >= 1 && j <= n - 2) {
                    g = el.row(j, tv[t][k], SHARED ? 0.0 : tx[t][k]);
                    if constexpr (!SHARED) tx[t][k] = el.c;
                }
                tv[t][k] = g;
            }
        }
        __syncthreads();
        if (T < tiles - 1) {   // the last tile stays here for the back substitution
            store(T, true);
            __syncthreads();
        }
    }
    if (tiles > 1) fetch_back(tiles - 2);
    double m = 0.0;
    for (int T = tiles - 1; T >= 0; --T) {
        if (T < tiles - 1) {
            stage();
            __syncthreads();
            if (T > 0) fetch_back(T - 1);
        }
        if (live) {
#pragma unroll 4
            for (int k = K - 1; k >= 0; --k) {
                const int j = T * K + k;
                if (j >= 1 && j <= n - 2) {
                    const double c = SHARED ? fac[3 * n + j] : tx[t][k];
                    m = tv[t][k] - c * m;
                    tv[t][k] = m;
                }
            }
        }
        __syncthreads();
        store(T, false);
        __syncthreads();
    }
}

long long blocks(long long systems, int per_block) { return (systems + per_block - 1) / per_block; }

template <bool SHARED, bool GIVEN>
void launch(bool tiled, const double* x, Axes xs, const double* v, Axes vs, double* out, Axes os,
            const double* fac, double* scratch, int n, long long na, long long nb, cudaStream_t stream) {
    if (tiled) {
        spline_tiled_kernel<SHARED, GIVEN><<<(unsigned)blocks(na * nb, kTileSystems), kTileSystems, 0, stream>>>(
            x, xs, v, vs, out, os, fac, scratch, n, na, nb);
    } else {
        spline_direct_kernel<SHARED, GIVEN><<<(unsigned)blocks(na * nb, kDirectThreads), kDirectThreads, 0, stream>>>(
            x, xs, v, vs, out, os, fac, scratch, n, na, nb);
    }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after each launch (0 on
// success). The caller checks shapes and allocates: n >= 4, na * nb >= 1
// systems, x, v and out float64 on one device, `fac` 4 n doubles when
// `shared` (x's batch strides both 0), else `scratch` n doubles a system.
// `tiled` takes the shared-memory tiles (for a contiguous knot axis), else
// one thread a system reads device memory directly.
extern "C" int spline_solve_launch(const void* x, long long xk, long long xa, long long xb,
                                   const void* v, long long vk, long long va, long long vb,
                                   void* out, long long ok, long long oa, long long ob,
                                   void* fac, void* scratch, int n, long long na, long long nb,
                                   int shared, int given, int tiled, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const double* xp = (const double*)x;
    const double* vp = (const double*)v;
    double* op = (double*)out;
    double* facp = (double*)fac;
    double* sp = (double*)scratch;
    const Axes xs{xk, xa, xb}, vs{vk, va, vb}, os{ok, oa, ob};
    if (shared) {
        spline_factors_kernel<<<1, 32, 0, st>>>(xp, xk, n, facp);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        if (given) launch<true, true>(tiled, xp, xs, vp, vs, op, os, facp, sp, n, na, nb, st);
        else launch<true, false>(tiled, xp, xs, vp, vs, op, os, facp, sp, n, na, nb, st);
    } else {
        if (given) launch<false, true>(tiled, xp, xs, vp, vs, op, os, facp, sp, n, na, nb, st);
        else launch<false, false>(tiled, xp, xs, vp, vs, op, os, facp, sp, n, na, nb, st);
    }
    return (int)cudaGetLastError();
}
