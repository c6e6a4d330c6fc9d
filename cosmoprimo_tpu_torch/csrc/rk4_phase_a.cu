// Phase A of the native perturbations: the fixed-step RK4 loop of the full
// Einstein-Boltzmann hierarchy, two threads a lane, every step in one launch.
//
// Replaces no TPU kernel. The JAX package integrates phase A in plain jnp
// under lax.scan (cosmoprimo_tpu/boltzmann/perturbations.py); the port's copy
// (boltzmann/perturbations.py: `_rk4_loop` over `deriv_full`, `_coefs_a` and
// `_project_a`) replays ~600 PyTorch kernels a step from CUDA graphs, each of
// them reading and writing whole (rows, B, nk) tensors in device memory. This
// kernel runs the same steps with each lane's state on the SM.
//
// Contract, for each lane (a cosmology b and a mode k; lane = b nk + i) over
// its grid eta_0 < ... < eta_n: the state y (N = 49 + 45 ns rows) starts at
// y0, its derivative at eta_0 is the first stage of the first step, and each
// step j is, as in `_rk4_loop`:
//   k2 = f(y + d/2 ydot, c_m), k3 = f(y + d/2 k2, c_m), k4 = f(y + d k3, c_1),
//   y1 = P(y + d/6 (((ydot + 2 k2) + 2 k3) + k4)), ydot1 = f(y1, c_1)
// with d = eta_{j+1} - eta_j, f = `deriv_full`, c_m and c_1 the coefficients
// (`_fetch` of tabs['stack'] and `_coefs_a`) at the step's midpoint and end,
// and P = `_project_a`: the exact drag map (`_drag_etd`, its factors from c_m,
// `_drag_coefs`), `_tca_project`, `_poisson_project`, `_ur_rsa_project`. Each
// harvest point h of the lane's cosmology with eta_j <= h < eta_{j+1} receives
// the linear blend of the rows of `_rows_a(ns)` between the step's start and
// end states; a non-decreasing grid holds each point in one step at most, so
// each is written once into the zeroed output. Every formula is the one of
// perturbations.py, in float64, its operations in the same order; a division
// of a tensor by a Python scalar is written as PyTorch's CUDA kernels run it,
// a multiplication by the scalar's reciprocal. A branch stands in for each
// torch.where: the value it drops never reaches the state.
//
// Layout. A block holds T lanes (64 for one massive species) and two roles,
// each a set of whole warps: the hierarchy's threads (thread t < T) own rows
// phi .. F_ur_LMAX_UR of lane t and their coefficients (the fetch of every
// table row, the fluids, the photons, the massless neutrinos, the
// projections), the massive neutrinos' threads (T + t) own the rows
// Psi_{s,q,l} and their coefficients (eps, the moment weights, q k / eps).
// A derivative needs both: the neutrinos' threads first put their sums of
// the metric's stress and momentum density into shared memory, the
// hierarchy's threads take them, make psi and phi' and put those back, and
// then each role makes its own rows (two block barriers a derivative, one
// a projection; the sums alternate between two slots, so a role that runs
// ahead never overwrites what the other has yet to read). Shared memory
// holds, a lane, the state y, the stage input, the stage derivative and the
// RK4 accumulator (4 N doubles), the ladders' couplings (l s_l k / (2l + 1)
// and (l + 1) s_{l+1} k / (2l + 1) for l = 0 .. LMAX_UR, and the same with
// 1 / (2l + 1) for the massive neutrinos), made once a lane from k and the
// curvature, and the exchanged sums; element r of a lane's buffer sits at
// r T + t, so a warp's 32 loads of one row are 256 contiguous bytes. The
// coefficients of one point live in registers until the next point's; the
// midpoint's drag factors are kept through the end point's. T is the largest
// multiple of 32 whose buffers fit the 227 KB a block may use: one block an
// SM, 2 T / 32 warps (four at one species). The PyTorch path takes one
// massive species or more (a massless row has one of mass 0), and so does
// the kernel: it is built for 1 to 3.
//
// What bounds it on an H100 SXM. A lane's step is ~5 500 float64 operations
// (four derivatives, the combination, the projections, two points'
// coefficients); device memory sees only the grid (one double a lane a step),
// the table rows of the fetch (from L2: the rows of a cosmology are shared by
// its lanes), the state once in and once out, and the harvest. At 65 536
// lanes x 2560 steps that is ~9e11 operations, ~27 ms at 33.5 TFLOP/s, and
// ~1.5 GB, ~0.5 ms at 3.35 TB/s: the arithmetic bounds it. With four warps
// an SM, one a partition, each warp waits on its own dependent operations
// and shared-memory loads: the kernel is latency-bound, well below that
// bound (PERF.md keeps the numbers).

#include <cuda_runtime.h>

namespace {

// the state layout of boltzmann/perturbations.py, one lane
constexpr int kLmaxG = 11, kLmaxPol = 11, kLmaxUr = 17, kLmaxNcdm = 8, kNq = 5;
constexpr int kPhi = 0, kDc = 1, kTc = 2, kDb = 3, kTb = 4, kDg = 5, kTg = 6, kDde = 7, kTde = 8;
constexpr int kFg = 9;                      // F_gamma_2 .. F_gamma_LMAX_G
constexpr int kGp = kFg + kLmaxG - 1;       // G_0 .. G_LMAX_POL
constexpr int kUr = kGp + kLmaxPol + 1;     // F_ur_0 .. F_ur_LMAX_UR
constexpr int kNc = kUr + kLmaxUr + 1;      // Psi_{s,q,l}, l = 0 .. LMAX_NCDM
constexpr int kNl = kLmaxNcdm + 1;
constexpr int kLadder = kLmaxUr + 1;        // couplings l = 0 .. LMAX_UR
constexpr double kTcaAh = 120.0, kTcaK = 50.0, kPoissonKah = 2.5, kRClosedMax = 0.2;
constexpr int kSharedMax = 232448;          // bytes of shared memory a block may use

__host__ __device__ constexpr int n_state(int ns) { return kNc + ns * kNq * kNl; }
__host__ __device__ constexpr int n_rows(int ns) { return 7 + 2 * ns * kNq; }   // `_rows_a(ns)`
// shared doubles a lane: 4 buffers, the couplings of both roles, the
// exchange (two slots of 3 sums, psi, phi'), the midpoint's drag factors and,
// from two species on, the massive neutrinos' coefficients (registers hold
// one species')
__host__ __device__ constexpr int ncdm_shared(int ns) { return ns > 1 ? 5 * ns * kNq : 0; }
__host__ __device__ constexpr int lane_doubles(int ns) {
    return 4 * n_state(ns) + 2 * kLadder + 2 * kNl + 8 + 5 + ncdm_shared(ns);
}
__host__ __device__ constexpr int lanes_per_block(int ns) {
    const int t = kSharedMax / (8 * lane_doubles(ns)) / 32 * 32;
    return t > 128 ? 128 : t;
}
__host__ __device__ constexpr int threads_per_block(int ns) { return 2 * lanes_per_block(ns); }

// The harvested row ri of `_rows_a(ns)`: phi .. delta_g, F_ur_0 (the
// hierarchy's, ri < 7), then Psi_0, Psi_1 of each (species, q).
__host__ __device__ constexpr int harvest_row(int ri) {
    return ri < 6 ? ri : ri == 6 ? kUr : kNc + (ri - 7) / 2 * kNl + (ri - 7) % 2;
}

struct Args {
    const double* y0;        // (N, lanes): the state at each lane's eta_0
    const double* eta;       // (n_steps + 1, lanes): the grids
    const double* stack;     // (13, B, M): tabs['stack']
    const double* lneta0;    // (B,)
    const double* dlneta;    // (B,)
    const double* K;         // (B,): the curvature [Mpc^-2]
    const double* wa;        // (B,): wa_fld
    const double* cs2;       // (B,): cs2_fld
    const double* am;        // (ns, B): m_ncdm / T_ncdm
    const double* k;         // (lanes,) [1/Mpc]
    const double* eta_rsa;   // (lanes,): the streaming switch, Lanes.eta_rsa
    const double* hz;        // (B, nz): the harvest points
    double* y_out;           // (N, lanes): the state at eta_n
    double* harvest;         // (nz, n_rows, lanes), zero on entry
    double q[kNq], q2[kNq], dlnf0[kNq], w2[kNq], w2q[kNq], w2q2[kNq];   // Lanes' momentum grid
    long long lanes;
    int nk, B, M, n_steps, nz;
};

// The uniform ln(eta) table of one cosmology.
struct Table {
    double lneta0, dlneta;
    const double* row0;      // tabs['stack'][0, b]
    long long stride;        // B M: from one stacked row to the next
    int M;
};

// `_fetch`'s index arithmetic at eta: the blend of table cell i.
struct Fetch {
    const double* p;
    long long stride;
    double w, w1;
    __device__ __forceinline__ double row(int r) const {
        const double* q = p + r * stride;
        return __ldg(q) * w1 + __ldg(q + 1) * w;
    }
};

// torch.clamp(u, 0, 1): NaN stays NaN
__device__ __forceinline__ double clamp01(double u) { return u < 0.0 ? 0.0 : (u > 1.0 ? 1.0 : u); }

__device__ __forceinline__ Fetch fetch(const Table& tb, double eta) {
    const double x = (log(eta) - tb.lneta0) / tb.dlneta;
    int i = (int)x;                          // x.to(int32), clamped to [0, M - 2]
    i = i < 0 ? 0 : (i > tb.M - 2 ? tb.M - 2 : i);
    const double w = clamp01(x - (double)i);
    return {tb.row0 + i, tb.stride, w, 1.0 - w};
}

// The hierarchy's factors of `Lanes` and the cosmology's scalars.
struct HierLane {
    double k, k2, s2, s2sq, f1, k43, eta_rsa, clo_g, clo_u;
    int b;
};

// The hierarchy's coefficients of `_coefs_a` at one point.
// (Those that are one product of others, as 0.1 kappa', are made where
// they are used; `closure1`'s photon entries are equal, 12 s_12, so the
// polarization's closure is the temperature's.)
struct Hier {
    bool tca, rsa, pin;
    double Hc, kp, fg, fur, fc, fb, fde;
    double mpsi, sg, su, thde, thu, g15, rfac, gtca, cb2k2;
    double e1, e2, e3, f1, f2, R, inv1R, sl1, sl2, a_tb;
    double clos_g, clos_u, pc1, pc2, tqs;
};
static_assert(kLmaxG == kLmaxPol, "one closure for both photon ladders");

// The massive neutrinos' coefficients at one point, by (species, q): in
// registers for one species, in shared memory (field f of (species, q) j at
// base[(f NS kNq + j) T]) for more.
template <int NS, int T, bool SHARED = (NS > 1)>
struct Ncdm {
    double v[5 * NS * kNq], clos_n;
    __device__ __forceinline__ double& at(int f, int j) { return v[f * NS * kNq + j]; }
    __device__ __forceinline__ double at(int f, int j) const { return v[f * NS * kNq + j]; }
};
template <int NS, int T>
struct Ncdm<NS, T, true> {
    double* base;
    double clos_n;
    __device__ __forceinline__ double& at(int f, int j) { return base[(f * NS * kNq + j) * T]; }
    __device__ __forceinline__ double at(int f, int j) const { return base[(f * NS * kNq + j) * T]; }
};
enum { kS2w, kT1w, kD0w, kQe, kSrc1n };

// `_coefs_a` of the hierarchy at eta.
__device__ __forceinline__ void hier_coefs(Hier& c, double eta, const Fetch& f, const HierLane& ln, const Args& a) {
    const double lna = f.row(0);
    const double Hc = exp(f.row(1)), kp = exp(f.row(2)), cb2 = exp(f.row(3));
    const double fg = exp(f.row(4)), fur = exp(f.row(5)), fc = exp(f.row(6)), fb = exp(f.row(7));
    const double fnc = exp(f.row(8)), fde = exp(f.row(9));
    const double w_nc = f.row(10), w_de = f.row(12);
    const double k = ln.k, k2 = ln.k2;
    c.Hc = Hc; c.kp = kp; c.fg = fg; c.fur = fur; c.fc = fc; c.fb = fb; c.fde = fde;
    const bool tca = (kp > kTcaAh * Hc) && (kp > kTcaK * k);
    const bool rsa = eta > ln.eta_rsa;
    c.tca = tca; c.rsa = rsa;
    const double G2 = Hc * Hc + __ldg(a.K + ln.b);
    const double G2k2 = G2 / k2;
    c.mpsi = 4.5 * (G2k2 / ln.s2sq);
    c.sg = tca ? 0.0 : (2.0 / 3.0) * fg;
    c.su = rsa ? 0.0 : (2.0 / 3.0) * fur;
    const double opw = 1.0 + w_de;
    c.thde = fde * opw;
    c.thu = rsa ? 0.0 : fur * k;
    c.g15 = 1.5 * G2k2;
    c.rfac = rsa ? 1.0 / (1.0 - 6.0 * G2k2 * fur) : 1.0;
    c.gtca = ln.s2 * (32.0 / 45.0) / kp;
    c.cb2k2 = cb2 * k2;
    const double cs2 = __ldg(a.cs2 + ln.b);
    const double R = (4.0 / 3.0) * fg / fb;
    const double wtot = (fg + fur) * (1.0 / 3.0) + w_nc * fnc + w_de * fde;
    c.e1 = -opw;
    c.e2 = -3.0 * Hc * (cs2 - w_de);
    c.e3 = -9.0 * (Hc * Hc) * (cs2 * opw - (w_de * opw + __ldg(a.wa + ln.b) * exp(lna) * (1.0 / 3.0))) / k2;
    c.f1 = -Hc * (1.0 - 3.0 * cs2);
    c.f2 = cs2 * k2 * (opw / (opw * opw + 1e-24));
    c.R = R;
    c.inv1R = 1.0 / (1.0 + R);
    c.sl1 = (2.0 * R / (1.0 + R)) * Hc;
    c.sl2 = R / (kp * (1.0 + R));
    c.a_tb = -(Hc * Hc - 0.5 * G2 * (1.0 + 3.0 * wtot));
    c.clos_g = ln.clo_g / eta;
    c.clos_u = ln.clo_u / eta;
    c.pin = k > kPoissonKah * Hc;
    c.pc1 = -1.5 * (G2 / (k2 * ln.s2sq));
    c.pc2 = 3.0 * Hc / k2;
    c.tqs = 1.0 / (kp * (1.0 + R));
}

// `_fetch`'s massive-neutrino factors and `_coefs_a`'s at eta.
template <int NS, int T>
__device__ __forceinline__ void ncdm_coefs(Ncdm<NS, T>& c, double eta, const Fetch& f, double k, double clo_n,
                                           const double (&am)[NS], const Args& a) {
    const double av = exp(f.row(0));
    const double fnc = exp(f.row(8));
    double eps[NS * kNq];
    double I_rho = 0.0;
#pragma unroll
    for (int j = 0; j < NS * kNq; ++j) {
        const int q = j % kNq;
        const double m = av * am[j / kNq];
        eps[j] = sqrt(a.q2[q] + m * m);
        I_rho = I_rho + a.w2[q] * eps[j];
    }
#pragma unroll
    for (int j = 0; j < NS * kNq; ++j) {
        const int q = j % kNq;
        c.at(kS2w, j) = fnc * (2.0 / 3.0) * (a.w2q2[q] / eps[j]) / I_rho;
        c.at(kT1w, j) = fnc * k * a.w2q[q] / I_rho;
        c.at(kD0w, j) = fnc * (a.w2[q] * eps[j]) / I_rho;
        c.at(kQe, j) = a.q[q] * k / eps[j];
        c.at(kSrc1n, j) = -(eps[j] * k / (3.0 * a.q[q])) * a.dlnf0[q];
    }
    c.clos_n = clo_n / eta;
}

// The massive neutrinos' share of `_metric_parts`: the weighted sums of
// Psi_2 (stress), Psi_1 (momentum density) and, for the Poisson pin, Psi_0.
template <int NS, int T>
__device__ __forceinline__ void ncdm_sums(const double* __restrict__ y, const Ncdm<NS, T>& c, double& ws2,
                                          double& wt1, double& wd0) {
    ws2 = 0.0, wt1 = 0.0, wd0 = 0.0;
#pragma unroll
    for (int j = 0; j < NS * kNq; ++j) {
        const int r = kNc + j * kNl;
        ws2 = ws2 + c.at(kS2w, j) * y[(r + 2) * T];
        wt1 = wt1 + c.at(kT1w, j) * y[(r + 1) * T];
        wd0 = wd0 + c.at(kD0w, j) * y[r * T];
    }
}

// `_metric_parts` and `_metric`, the neutrinos' sums given.
template <int T>
__device__ __forceinline__ void metric(const double* __restrict__ y, const Hier& c, double ws2, double wt1,
                                       double& stress, double& theta, double& psi, double& phip) {
    stress = c.sg * y[kFg * T] + c.su * y[(kUr + 2) * T] + ws2;
    theta = c.fc * y[kTc * T] + c.fb * y[kTb * T] + (4.0 / 3.0) * c.fg * y[kTg * T] + wt1 + c.thde * y[kTde * T] +
            c.thu * y[(kUr + 1) * T];
    psi = y[kPhi * T] - c.mpsi * stress;
    phip = c.rfac * (c.g15 * theta - c.Hc * psi);
}

// `deriv_full`'s rows phi .. F_ur_LMAX_UR: o = d/deta of the state y.
template <int T>
__device__ __forceinline__ void hier_rows(const double* __restrict__ y, double* __restrict__ o, const Hier& c,
                                          const HierLane& ln, const double* __restrict__ D,
                                          const double* __restrict__ U, double psi, double phip) {
    const double k2 = ln.k2;
    const double tc = y[kTc * T], db = y[kDb * T], tb = y[kTb * T], dg = y[kDg * T], tg = y[kTg * T];
    const double dde = y[kDde * T], tde = y[kTde * T];
    const double Fg = y[kFg * T], G0 = y[kGp * T], G2 = y[(kGp + 2) * T];
    const double Fg2 = c.tca ? c.gtca * tg : Fg;
    const double k2psi = k2 * psi;
    const double p3 = 3.0 * phip;
    const double ddb = p3 - tb;
    const double ddg = 4.0 * phip - (4.0 / 3.0) * tg;
    o[kPhi * T] = phip;
    o[kDc * T] = p3 - tc;
    o[kTc * T] = k2psi - c.Hc * tc;
    o[kDb * T] = ddb;
    o[kDg * T] = ddg;
    o[kDde * T] = c.e1 * (tde - p3) + c.e2 * dde + c.e3 * tde;
    o[kTde * T] = c.f1 * tde + c.f2 * dde + k2psi;
    // baryon-photon momentum: drag-free outside tight coupling, MB95 eq. 74-75 inside
    const double dtb_full = c.cb2k2 * db - c.Hc * tb + k2psi;
    const double dtg_full = k2 * (0.25 * dg - 0.5 * ln.s2 * Fg2) + k2psi;
    if (c.tca) {
        const double slip = c.sl1 * (tb - tg) +
                            c.sl2 * (c.a_tb * tb + -0.5 * c.Hc * k2 * dg + -c.Hc * k2 * psi + c.cb2k2 * ddb -
                                     (0.25 * k2) * ddg);
        const double dtb_tca = (dtb_full + c.R * (dtg_full + slip)) * c.inv1R;
        o[kTb * T] = dtb_tca;
        o[kTg * T] = dtb_tca - slip;
    } else {
        o[kTb * T] = dtb_full;
        o[kTg * T] = dtg_full;
    }
    // the photon ladders F_gamma_2 .. L and G_0 .. L with scattering and
    // closures; F_gamma_2 takes F_gamma_1 as the source f1 theta_g
    const double PI = Fg2 + G0 + G2;
#pragma unroll
    for (int r = kFg; r < kUr; ++r) {
        const bool pol = r >= kGp;
        const int l = pol ? r - kGp : r - kFg + 2;
        const bool top = l == (pol ? kLmaxPol : kLmaxG);
        double v = 0.0;
        if (r != kFg) v = (top ? D[l * T] + U[l * T] : D[l * T]) * y[(r - 1) * T];
        if (!top) v = v - U[l * T] * y[(r + 1) * T];
        v = v - c.kp * y[r * T];
        if (r == kGp - 1) v = v - c.clos_g * y[r * T];
        if (r == kUr - 1) v = v - c.clos_g * y[r * T];
        if (r == kFg) v = v + (ln.f1 * tg + 0.1 * c.kp * (Fg + G0 + G2));
        if (r == kGp) v = v + 0.5 * c.kp * PI;
        if (r == kGp + 2) v = v + 0.1 * c.kp * PI;
        o[r * T] = v;
    }
    // the massless neutrinos, held at zero where they stream
    if (c.rsa) {
#pragma unroll
        for (int r = kUr; r < kNc; ++r) o[r * T] = 0.0;
    } else {
#pragma unroll
        for (int r = kUr; r < kNc; ++r) {
            const int l = r - kUr;
            const bool top = l == kLmaxUr;
            double v = (top ? D[l * T] + U[l * T] : D[l * T]) * y[(r - 1) * T];
            if (!top) v = v - U[l * T] * y[(r + 1) * T];
            if (top) v = v - c.clos_u * y[r * T];
            if (l == 0) v = v + 4.0 * phip;
            if (l == 1) v = v + ln.k43 * psi;
            o[r * T] = v;
        }
    }
}

// `deriv_full`'s massive-neutrino rows: the ladder of each (species, q)
// with pre = q k / eps.
template <int NS, int T>
__device__ __forceinline__ void ncdm_rows(const double* __restrict__ y, double* __restrict__ o, const Ncdm<NS, T>& c,
                                          const double* __restrict__ Dn, const double* __restrict__ Un, double psi,
                                          double phip, const Args& a) {
#pragma unroll
    for (int j = 0; j < NS * kNq; ++j) {
        const int q = j % kNq;
#pragma unroll
        for (int l = 0; l < kNl; ++l) {
            const int r = kNc + j * kNl + l;
            const bool top = l == kLmaxNcdm;
            // l = 0 has no coupling below (l s_l = 0), so the row below, the
            // hierarchy's for the first block, is not read
            double v = l == 0 ? 0.0 : (top ? Dn[l * T] + Un[l * T] : Dn[l * T]) * y[(r - 1) * T];
            if (!top) v = v - Un[l * T] * y[(r + 1) * T];
            v = v * c.at(kQe, j);
            if (top) v = v - c.clos_n * y[r * T];
            if (l == 0) v = v - phip * a.dlnf0[q];
            if (l == 1) v = v + c.at(kSrc1n, j) * psi;
            o[r * T] = v;
        }
    }
}

// `_project_a`'s first part on the hierarchy's rows: the exact drag map over
// the step (the midpoint's factors dm: kappa', R, 1/(1+R), cb2 k^2, Hc; the
// step's start rows y0 = DB, TB, DG, TG, F_2) where tight coupling is off at
// the end point, the slaved photon moments where it holds.
template <int T>
__device__ __forceinline__ void drag_tca(double* __restrict__ y, const double (&y0)[5], double d,
                                         const double* __restrict__ dm, const Hier& c, const HierLane& ln) {
    const double k2 = ln.k2;
    if (!c.tca) {
        // `_drag_coefs` and `_drag_etd`
        const double kp = dm[0], R = dm[T], inv1R = dm[2 * T], cb2k2 = dm[3 * T], Hc = dm[4 * T];
        const double z = kp * (1.0 + R) * d;
        const double phi1 = z > 1e-8 ? -expm1(-z) / z : 1.0 - 0.5 * z;
        const double e = exp(-z), dphi1 = d * phi1;
        const double ym_db = 0.5 * (y0[0] + y[kDb * T]), ym_tb = 0.5 * (y0[1] + y[kTb * T]);
        const double ym_dg = 0.5 * (y0[2] + y[kDg * T]), ym_fg = 0.5 * (y0[4] + y[kFg * T]);
        const double Dm = cb2k2 * ym_db - Hc * ym_tb - k2 * (0.25 * ym_dg - 0.5 * ym_fg);
        const double S_new = (y0[1] - y0[3]) * e + dphi1 * Dm;
        const double V = (y[kTb * T] + R * y[kTg * T]) * inv1R;
        y[kTb * T] = V + R * inv1R * S_new;
        y[kTg * T] = V - inv1R * S_new;
    } else {
        // `_tca_project`
        const double Dt = c.cb2k2 * y[kDb * T] - c.Hc * y[kTb * T] -
                          k2 * (0.25 * y[kDg * T] - 0.5 * ln.s2 * c.gtca * y[kTg * T]);
        const double tg = y[kTb * T] - Dt * c.tqs;
        y[kTg * T] = tg;
        const double Fg2 = c.gtca * tg;
        y[kFg * T] = Fg2;
        y[kGp * T] = 1.25 * Fg2;
        y[(kGp + 2) * T] = 0.25 * Fg2;
#pragma unroll
        for (int r = kFg + 1; r < kGp; ++r) y[r * T] = 0.0;
        y[(kGp + 1) * T] = 0.0;
#pragma unroll
        for (int r = kGp + 3; r < kUr; ++r) y[r * T] = 0.0;
    }
}

// `_project_a`'s second part: `_poisson_project` and `_ur_rsa_project`, the
// neutrinos' sums given.
template <int T>
__device__ __forceinline__ void pin_stream(double* __restrict__ y, const Hier& c, const HierLane& ln, double ws2,
                                           double wt1, double wd0) {
    double stress, theta, psi, phip;
    metric<T>(y, c, ws2, wt1, stress, theta, psi, phip);
    if (c.pin) {
        const double dur = c.rsa ? -4.0 * psi : y[kUr * T];
        const double Delta = c.fg * y[kDg * T] + c.fur * dur + c.fc * y[kDc * T] + c.fb * y[kDb * T] + wd0 +
                             c.fde * y[kDde * T];
        const double th = c.rsa ? theta + (4.0 / 3.0) * c.fur * 3.0 * phip : theta;
        y[kPhi * T] = c.pc1 * (Delta + c.pc2 * th);
    }
    if (c.rsa) {
        const double psi1 = y[kPhi * T] - c.mpsi * stress;
        const double phip1 = c.rfac * (c.g15 * theta - c.Hc * psi1);
        y[kUr * T] = -4.0 * psi1;
        y[(kUr + 1) * T] = 4.0 * phip1 / ln.k;
#pragma unroll
        for (int r = kUr + 2; r < kNc; ++r) y[r * T] = 0.0;
    }
}

template <int NS, int T>
__global__ void __launch_bounds__(threads_per_block(NS), 1) rk4_phase_a_kernel(const Args a) {
    constexpr int N = n_state(NS);
    constexpr int NR = n_rows(NS);
    static_assert(NS > 0, "the massive neutrinos' role needs one species or more");
    extern __shared__ double smem[];
    const int t = threadIdx.x % T;
    const bool nu = threadIdx.x >= T;             // the massive neutrinos' role: whole warps
    // rows [lo, hi) of the state and [rlo, rhi) of the harvest are this thread's
    const int lo = nu ? kNc : 0, hi = nu ? N : kNc;
    const int rlo = nu ? 7 : 0, rhi = nu ? NR : 7;
    const long long L = a.lanes;
    const long long lane0 = (long long)blockIdx.x * T + t;
    const bool live = lane0 < L;                  // the block's last lanes may be past the end: they
    const long long lane = live ? lane0 : L - 1;  // run lane L - 1's steps for the barriers, and write nothing
    double* const y = smem + t;                   // row r at y[r T]
    double* const s = y + N * T;                  // the stage input
    double* const kb = s + N * T;                 // the stage derivative
    double* const acc = kb + N * T;               // ydot + 2 k2 + 2 k3 + k4
    double* const D = acc + N * T;                // ladder couplings, l = 0 .. LMAX_UR
    double* const U = D + kLadder * T;
    double* const Dn = U + kLadder * T;           // one massive-neutrino block
    double* const Un = Dn + kNl * T;
    double* const X = Un + kNl * T;               // two slots of the neutrinos' sums ws2, wt1, wd0
    double* const P = X + 6 * T;                  // psi, phi'
    double* const G = P + 2 * T;                  // the midpoint's drag factors
    double* const Q = G + 5 * T;                  // the neutrinos' coefficients, from two species on
    const int b = (int)(lane / a.nk);

    // the couplings of k and the curvature (`Lanes`, `_s_table`, `_ladder`), made once
    const double k = a.k[lane];
    const double k2 = k * k;
    double r = a.K[b] / k2;
    r = r > kRClosedMax ? kRClosedMax : r;
    double sl[kLadder + 1];
#pragma unroll
    for (int l = 0; l <= kLadder; ++l) {
        const double v = 1.0 - (double)(l * l - 1) * r;
        sl[l] = sqrt(v < 0.0 ? 0.0 : v);
    }
    HierLane ln;
    double am[NS];
    double clo_n = 0.0;
    if (!nu) {
#pragma unroll
        for (int l = 0; l < kLadder; ++l) {   // pre = k
            const double kd = k / (2.0 * l + 1.0);
            D[l * T] = kd * (l * sl[l]);
            U[l * T] = kd * ((l + 1.0) * sl[l + 1]);
        }
        ln.k = k;
        ln.k2 = k2;
        ln.s2 = sl[2];
        ln.s2sq = 1.0 - 3.0 * r;
        ln.f1 = D[2 * T] * 4.0 / (3.0 * k);
        ln.k43 = (4.0 / 3.0) * k;
        ln.eta_rsa = a.eta_rsa[lane];
        ln.clo_g = (kLmaxG + 1.0) * sl[kLmaxG + 1];
        ln.clo_u = (kLmaxUr + 1.0) * sl[kLmaxUr + 1];
        ln.b = b;
    } else {
#pragma unroll
        for (int l = 0; l < kNl; ++l) {       // pre = 1
            const double inv = 1.0 / (2.0 * l + 1.0);
            Dn[l * T] = inv * (l * sl[l]);
            Un[l * T] = inv * ((l + 1.0) * sl[l + 1]);
        }
        clo_n = (kLmaxNcdm + 1.0) * sl[kLmaxNcdm + 1];
#pragma unroll
        for (int sp = 0; sp < NS; ++sp) am[sp] = a.am[(long long)sp * a.B + b];
    }
    const Table tb{a.lneta0[b], a.dlneta[b], a.stack + (long long)b * a.M, (long long)a.B * a.M, a.M};

    for (int i = lo; i < hi; ++i) y[i * T] = a.y0[i * L + lane];
    const double* hz = a.hz + (long long)b * a.nz;
    Hier c;
    Ncdm<NS, T> cn;
    if constexpr (NS > 1) cn.base = Q;
    auto coefs = [&](double eta) {
        const Fetch f = fetch(tb, eta);
        if (!nu) hier_coefs(c, eta, f, ln, a);
        else ncdm_coefs<NS, T>(cn, eta, f, k, clo_n, am, a);
    };
    int slot = 0;
    // o = f(in): the neutrinos' sums, then psi and phi', then each role's rows
    auto derivative = [&](const double* __restrict__ in, double* __restrict__ o) {
        double* const x = X + 3 * slot * T;
        if (nu) {
            double ws2, wt1, wd0;
            ncdm_sums<NS, T>(in, cn, ws2, wt1, wd0);
            x[0] = ws2;
            x[T] = wt1;
        }
        __syncthreads();
        double stress, theta, psi = 0.0, phip = 0.0;
        if (!nu) {
            metric<T>(in, c, x[0], x[T], stress, theta, psi, phip);
            P[0] = psi;
            P[T] = phip;
        }
        __syncthreads();
        if (!nu) hier_rows<T>(in, o, c, ln, D, U, psi, phip);
        else ncdm_rows<NS, T>(in, o, cn, Dn, Un, P[0], P[T], a);
        slot ^= 1;
    };

    double e1 = a.eta[lane];
    coefs(e1);
    for (int j = 0; j < a.n_steps; ++j) {
        const double e0 = e1;
        e1 = a.eta[(long long)(j + 1) * L + lane];
        const double d = e1 - e0, hd = 0.5 * d, d6 = d * (1.0 / 6.0);
        derivative(y, kb);                         // ydot: the first stage, at the coefficients of eta_j
        // the harvest points this step holds take the start state's rows
        bool hit = false;
        for (int iz = 0; iz < a.nz; ++iz) {
            const double h = __ldg(hz + iz);
            if (e0 <= h && e1 > h) {
                hit = true;
#pragma unroll
                for (int ri = 0; ri < NR; ++ri)
                    if (live && ri >= rlo && ri < rhi)
                        a.harvest[((long long)iz * NR + ri) * L + lane] = y[harvest_row(ri) * T];
            }
        }
        for (int i = lo; i < hi; ++i) {
            const double v = kb[i * T];
            acc[i * T] = v;
            s[i * T] = y[i * T] + hd * v;
        }
        coefs(0.5 * (e0 + e1));
        if (!nu) {
            G[0] = c.kp;
            G[T] = c.R;
            G[2 * T] = c.inv1R;
            G[3 * T] = c.cb2k2;
            G[4 * T] = c.Hc;
        }
#pragma unroll 1
        for (int st = 0; st < 3; ++st) {
            if (st == 2) coefs(e1);
            derivative(s, kb);
            if (st < 2) {
                const double h = st == 0 ? hd : d;
                for (int i = lo; i < hi; ++i) {
                    const double v = kb[i * T];
                    acc[i * T] = acc[i * T] + 2.0 * v;
                    s[i * T] = y[i * T] + h * v;
                }
            } else {
                for (int i = lo; i < hi; ++i) acc[i * T] = acc[i * T] + kb[i * T];
            }
        }
        if (!nu) {
            const double y0[5] = {y[kDb * T], y[kTb * T], y[kDg * T], y[kTg * T], y[kFg * T]};
            for (int i = lo; i < hi; ++i) y[i * T] = y[i * T] + d6 * acc[i * T];
            drag_tca<T>(y, y0, d, G, c, ln);
        } else {
            for (int i = lo; i < hi; ++i) y[i * T] = y[i * T] + d6 * acc[i * T];
        }
        double* const x = X + 3 * slot * T;
        if (nu) {
            double ws2, wt1, wd0;
            ncdm_sums<NS, T>(y, cn, ws2, wt1, wd0);
            x[0] = ws2;
            x[T] = wt1;
            x[2 * T] = wd0;
        }
        __syncthreads();
        if (!nu) pin_stream<T>(y, c, ln, x[0], x[T], x[2 * T]);
        slot ^= 1;
        if (hit) {
            for (int iz = 0; iz < a.nz; ++iz) {
                const double h = __ldg(hz + iz);
                if (e0 <= h && e1 > h) {
                    const double w = clamp01((h - e0) / (d > 0.0 ? d : 1.0));
#pragma unroll
                    for (int ri = 0; ri < NR; ++ri) {
                        if (live && ri >= rlo && ri < rhi) {
                            double* out = a.harvest + ((long long)iz * NR + ri) * L + lane;
                            const double ys = *out;
                            *out = ys + w * (y[harvest_row(ri) * T] - ys);
                        }
                    }
                }
            }
        }
    }
    if (live)
        for (int i = lo; i < hi; ++i) a.y_out[i * L + lane] = y[i * T];
}

// ---- the launch

template <int NS>
int launch(const Args& a, cudaStream_t stream) {
    constexpr int T = lanes_per_block(NS);
    static_assert(T >= 32, "a block must hold one warp of lanes");
    constexpr int bytes = T * lane_doubles(NS) * 8;
    cudaError_t err = cudaFuncSetAttribute(rk4_phase_a_kernel<NS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (a.lanes + T - 1) / T;
    rk4_phase_a_kernel<NS, T><<<(unsigned)blocks, threads_per_block(NS), bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Lanes a block, threads a block and bytes of shared memory a block for `ns`
// massive species; lanes 0 where the kernel is not built for that many.
extern "C" int rk4_phase_a_block(int ns, int* threads, int* shared_bytes) {
    switch (ns) {
#define RK4_BLOCK(NS)                                                       \
        case NS:                                                            \
            *threads = threads_per_block(NS);                               \
            *shared_bytes = lanes_per_block(NS) * lane_doubles(NS) * 8;     \
            return lanes_per_block(NS);
        RK4_BLOCK(1)
        RK4_BLOCK(2)
        RK4_BLOCK(3)
#undef RK4_BLOCK
        default: *threads = 0; *shared_bytes = 0; return 0;
    }
}

// Launch phase A on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, makes every array contiguous float64 on
// one device and zeroes `harvest`. `ptrs`: y0, eta, stack, lneta0, dlneta, K,
// wa, cs2, am, k, eta_rsa, hz, y_out, harvest (see Args); `consts`: q, q2,
// dlnf0, w2, w2q, w2q2 (5 each); `sizes`: lanes, nk, B, M, n_steps, nz, ns.
extern "C" int rk4_phase_a_launch(void* const* ptrs, const double* consts, const long long* sizes, void* stream) {
    Args a;
    a.y0 = (const double*)ptrs[0];
    a.eta = (const double*)ptrs[1];
    a.stack = (const double*)ptrs[2];
    a.lneta0 = (const double*)ptrs[3];
    a.dlneta = (const double*)ptrs[4];
    a.K = (const double*)ptrs[5];
    a.wa = (const double*)ptrs[6];
    a.cs2 = (const double*)ptrs[7];
    a.am = (const double*)ptrs[8];
    a.k = (const double*)ptrs[9];
    a.eta_rsa = (const double*)ptrs[10];
    a.hz = (const double*)ptrs[11];
    a.y_out = (double*)ptrs[12];
    a.harvest = (double*)ptrs[13];
    for (int q = 0; q < kNq; ++q) {
        a.q[q] = consts[q];
        a.q2[q] = consts[kNq + q];
        a.dlnf0[q] = consts[2 * kNq + q];
        a.w2[q] = consts[3 * kNq + q];
        a.w2q[q] = consts[4 * kNq + q];
        a.w2q2[q] = consts[5 * kNq + q];
    }
    a.lanes = sizes[0];
    a.nk = (int)sizes[1];
    a.B = (int)sizes[2];
    a.M = (int)sizes[3];
    a.n_steps = (int)sizes[4];
    a.nz = (int)sizes[5];
    const cudaStream_t st = (cudaStream_t)stream;
    switch (sizes[6]) {
        case 1: return launch<1>(a, st);
        case 2: return launch<2>(a, st);
        case 3: return launch<3>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
