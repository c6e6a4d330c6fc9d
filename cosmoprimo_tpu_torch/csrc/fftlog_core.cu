// FFTLog core, two rows per complex FFT, in native float64 / complex128.
//
// Replaces the Pallas TPU kernel cosmoprimo_tpu/ops/pallas_fft.py::fftlog_pallas
// (kernel body _kernel_body, butterflies _stage_dit / _stage_dif, host
// twiddles _twiddle_tables). That kernel works in double-single float32
// arithmetic, takes its input bit-reversed from device memory and its complex
// constants split on the host, all because the TPU has no 64-bit types. This
// card has native f64, so none of that is carried over.
//
// Contract, for row r of x (rows, size) with p = r % nparallel and n = 2^log2n:
//   f[j]   = pre[p, j] * x[r, j - in_left]   for in_left <= j < in_left + size, else 0
//   t      = irfft(conj(rfft(f) * u[p]), n)   with u[p] the half spectrum (n/2 + 1,)
//   out[r, j] = post[p, out_left + j] * t[out_left + j]   for 0 <= j < size
// which is cosmoprimo_tpu/ops/pallas_fft.py::fftlog_pair_reference with the
// zero padding, the prefactor and the crop fused in.
//
// Two rows per complex FFT. With F = fft(f) and u_ext the Hermitian extension
// of u, made real at bins 0 and n/2 (irfft ignores the imaginary part there),
// a row's result is t = fft(u_ext * F) / n, a real vector. One block takes rows
// a and b = a + nparallel, which share p and so u[p]: it transforms
// z = f_a + i f_b, multiplies by u_ext, transforms again, and
// fft(u_ext * fft(z)) / n = t_a + i t_b. Taking only Re(u) at bins 0 and n/2 is
// what keeps the two rows apart: a complex u there would mix row b into row a.
// Each row is scaled by 2^-e (e from frexp of its max |f|) before packing and
// by 2^e after, so that the round-off of a large row does not leak into a small
// one; powers of two are exact. A row with a non-finite value gives a NaN row
// and leaves its partner untouched, as a per-row FFT would.
//
// Register-resident passes. Both FFTs are Stockham autosort passes (natural
// order in and out), so the load from x and the store to out are in natural
// order and coalesced, with no bit reversal. Each thread holds 16 complex
// values in registers (32 at n = 8192, which keeps the block at 256 threads
// and so allows up to 255 registers a thread) and runs radix-16 butterflies
// there, with a radix 2^(log2n mod 4) pass where 16 does not divide n:
// n = 2048 is 16 x 16 x 8, then 8 x 16 x 16. The first FFT's last pass, the
// multiply by u and the second FFT's first pass work on the same registers, so
// shared memory carries only the exchanges between passes: 4 at n = 2048. The
// exchange buffer keeps re and im as separate double arrays padded by one
// double in 16 (index d + d / 16), which makes every exchange of every plan
// free of bank conflicts. Twiddles come from the host table exp(-2 pi i k / n),
// k < n/2, through the read-only cache: a radix-R pass loads w, w^2, w^4, ...
// and applies them by the bits of r, log2(R) loads instead of R - 1.
//
// What bounds it on an H100 SXM. At the headline (40 000 rows, size 1024,
// n 2048) the kernel reads 0.33 GB and writes 0.33 GB of device memory:
// 0.655 GB, 0.196 ms at 3.35 TB/s. Packed, its f64 work is 2 FFTs of
// 5 n log2(n) flops per pair, 4.5 GFLOP, 0.13 ms at ~34 TFLOP/s of f64 vector
// math. Shared-memory traffic per pair is 4 exchanges x 2048 x 16 B x 2
// = 0.26 MB, against 1.44 MB per row (2.9 MB per pair) in the radix-2 kernel
// this design replaced, which had 22 shared-memory passes per row, two of them
// bit-reversed and 8-way conflicted; barriers per pair fall from 44 to 9.
// Counted as issued instructions, the f64 work is ~4e9 adds, multiplies and
// FMAs, ~0.25 ms at 64 a clock on each of the 132 SMs, so the SMs, not device
// memory, bound this kernel: at n = 2048 it needs 136 registers a thread,
// which leaves 3 blocks (12 warps) on an SM to hide the exchanges and loads.
//
// Measured on NVIDIA H100 80GB HBM3, 700 W: 0.55 ms at the headline shape and
// 0.064 ms at (4096, 1024 -> 2048), against 3.91 ms and 0.441 ms for unfused
// torch.fft, and 5.01 ms and 0.531 ms for the radix-2 kernel. With the FFTs
// taken out it runs in 0.28 ms, and without its device-memory traffic in
// 0.50 ms. PERF.md keeps the numbers of each run.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr double kC1 = 0.92387953251128674;  // cos(pi / 8)
constexpr double kC2 = 0.70710678118654752;  // cos(pi / 4)
constexpr double kC3 = 0.38268343236508977;  // cos(3 pi / 8)

// cos(2 pi m / 16) for 0 <= m < 8
__host__ __device__ constexpr double cos16(int m) {
    return m == 0 ? 1.0 : m == 1 ? kC1 : m == 2 ? kC2 : m == 3 ? kC3 : m == 4 ? 0.0 : m == 5 ? -kC3
         : m == 6 ? -kC2 : -kC1;
}

__host__ __device__ constexpr int bit_reverse(int k, int bits) {
    int r = 0;
    for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
    return r;
}

// Radix plan for n = 2^LOG2N: kThreads threads of kValues values each. The
// first FFT runs passes of radix 16, ..., 16, 2^kLastLog2R; the second
// 2^kLastLog2R, 16, ..., 16. In a pass of radix R a thread runs kValues / R
// butterflies ("items"); item i of thread t is j = t + i * kThreads.
template <int LOG2N>
struct Plan {
    static constexpr int kLog2Radix = 4;
    static constexpr int kRadix = 1 << kLog2Radix;
    static constexpr int kN = 1 << LOG2N;
    static constexpr int kThreads = kN / kRadix < 256 ? kN / kRadix : 256;
    static constexpr int kValues = kN / kThreads;
    static constexpr int kPasses = (LOG2N + kLog2Radix - 1) / kLog2Radix;
    static constexpr int kLastLog2R = LOG2N - kLog2Radix * (kPasses - 1);
    static constexpr int kPadded = kN + kN / 16;
    static constexpr int kWarps = kThreads > 32 ? kThreads / 32 : 1;
    static constexpr size_t kSmem = sizeof(double) * (2 * kPadded + 2 * kWarps);

    __host__ __device__ static constexpr int log2r(bool second, int s) {
        return second ? (s == 0 ? kLastLog2R : kLog2Radix) : (s == kPasses - 1 ? kLastLog2R : kLog2Radix);
    }
    // log2 of the Stockham span Ns: the product of the radices of earlier passes
    __host__ __device__ static constexpr int log2ns(bool second, int s) {
        return second ? (s == 0 ? 0 : kLastLog2R + kLog2Radix * (s - 1)) : kLog2Radix * s;
    }
};

__device__ __forceinline__ int padded(int d) { return d + (d >> 4); }

__device__ __forceinline__ void cmul(double& re, double& im, double wr, double wi) {
    const double r = re * wr - im * wi;
    im = re * wi + im * wr;
    re = r;
}

// (re, im) *= exp(-2 pi i M / 16), 0 <= M < 8
template <int M>
__device__ __forceinline__ void rotate16(double& re, double& im) {
    if constexpr (M == 4) {
        const double r = re;
        re = im;
        im = -r;
    } else if constexpr (M != 0) {
        cmul(re, im, cos16(M), -cos16(M < 4 ? 4 - M : M - 4));
    }
}

// Radix-2 decimation-in-frequency stages over the R values at re/im[OFF ...]:
// butterfly B of the stage of span H, then the rest of that stage, then the
// stages of span H/2 ... 1. Every register index is a constant.
template <int OFF, int R, int H, int B = 0, int V>
__device__ __forceinline__ void dif_stages(double (&re)[V], double (&im)[V]) {
    if constexpr (B < R / 2) {
        constexpr int j = B % H, a = OFF + (B / H) * 2 * H + j, b = a + H;
        double dr = re[a] - re[b], di = im[a] - im[b];
        re[a] += re[b];
        im[a] += im[b];
        rotate16<j * (8 / H)>(dr, di);
        re[b] = dr;
        im[b] = di;
        dif_stages<OFF, R, H, B + 1>(re, im);
    } else if constexpr (H > 1) {
        dif_stages<OFF, R, H / 2>(re, im);
    }
}

// Undo the bit reversal of the stages above: a renaming of registers.
template <int OFF, int LOG2R, int K = 0, int V>
__device__ __forceinline__ void unscramble(double (&re)[V], double (&im)[V], double (&tr)[1 << LOG2R],
                                           double (&ti)[1 << LOG2R]) {
    if constexpr (K < (1 << LOG2R)) {
        constexpr int from = OFF + bit_reverse(K, LOG2R);
        tr[K] = re[from];
        ti[K] = im[from];
        unscramble<OFF, LOG2R, K + 1>(re, im, tr, ti);
    }
}

// In-register DFT of the 2^LOG2R values at re/im[OFF ...], natural order in
// and out.
template <int OFF, int LOG2R, int V>
__device__ __forceinline__ void dft(double (&re)[V], double (&im)[V]) {
    constexpr int R = 1 << LOG2R;
    dif_stages<OFF, R, R / 2>(re, im);
    double tr[R], ti[R];
    unscramble<OFF, LOG2R>(re, im, tr, ti);
#pragma unroll
    for (int k = 0; k < R; ++k) {
        re[OFF + k] = tr[k];
        im[OFF + k] = ti[k];
    }
}

// exp(-2 pi i idx / n) for 0 <= idx < n from the table of its first half
__device__ __forceinline__ void twiddle(const double2* __restrict__ tw, int idx, int half, double& wr,
                                        double& wi) {
    const double2 w = __ldg(tw + (idx < half ? idx : idx - half));
    wr = idx < half ? w.x : -w.x;
    wi = idx < half ? w.y : -w.y;
}

// One Stockham pass in registers, item I and the items after it: item
// j = t + I * threads holds the values at j + r * n / R (r < R) in slots
// I * R + r; multiply value r by w^r, w = exp(-2 pi i (j mod Ns) / (Ns R)), then
// take the DFT.
template <int LOG2N, int LOG2R, int LOG2NS, int I = 0>
__device__ __forceinline__ void radix_pass(double (&re)[Plan<LOG2N>::kValues], double (&im)[Plan<LOG2N>::kValues],
                                           const double2* __restrict__ tw, int t) {
    constexpr int N = 1 << LOG2N, R = 1 << LOG2R, NS = 1 << LOG2NS, T = Plan<LOG2N>::kThreads;
    if constexpr (I < Plan<LOG2N>::kValues / R) {
        if constexpr (NS > 1) {
            const int base = ((t + I * T) & (NS - 1)) * (N / (NS * R));
#pragma unroll
            for (int b = 0; b < LOG2R; ++b) {
                double wr, wi;
                twiddle(tw, base << b, N / 2, wr, wi);
#pragma unroll
                for (int r = 1; r < R; ++r)
                    if (r & (1 << b)) cmul(re[I * R + r], im[I * R + r], wr, wi);
            }
        }
        dft<I * R, LOG2R>(re, im);
        radix_pass<LOG2N, LOG2R, LOG2NS, I + 1>(re, im, tw, t);
    }
}

// Write the output of a pass (radix 2^LOG2R, span 2^LOG2NS) to its Stockham
// places in shared memory and read the inputs of the next pass (radix 2^LOG2R2).
template <int LOG2N, int LOG2R, int LOG2NS, int LOG2R2>
__device__ __forceinline__ void exchange(double (&re)[Plan<LOG2N>::kValues], double (&im)[Plan<LOG2N>::kValues],
                                         double* sre, double* sim, int t) {
    constexpr int N = 1 << LOG2N, R = 1 << LOG2R, NS = 1 << LOG2NS, R2 = 1 << LOG2R2;
    constexpr int T = Plan<LOG2N>::kThreads, V = Plan<LOG2N>::kValues;
    __syncthreads();  // the previous exchange's reads are done
#pragma unroll
    for (int i = 0; i < V / R; ++i) {
        const int j = t + i * T;
        const int dst = (j >> LOG2NS) * (NS * R) + (j & (NS - 1));
#pragma unroll
        for (int r = 0; r < R; ++r) {
            sre[padded(dst + r * NS)] = re[i * R + r];
            sim[padded(dst + r * NS)] = im[i * R + r];
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < V / R2; ++i) {
#pragma unroll
        for (int r = 0; r < R2; ++r) {
            const int d = padded(t + i * T + r * (N / R2));
            re[i * R2 + r] = sre[d];
            im[i * R2 + r] = sim[d];
        }
    }
}

template <int LOG2N, bool SECOND, int S = 0>
__device__ __forceinline__ void fft(double (&re)[Plan<LOG2N>::kValues], double (&im)[Plan<LOG2N>::kValues],
                                    double* sre, double* sim, const double2* __restrict__ tw, int t) {
    using P = Plan<LOG2N>;
    constexpr int LOG2R = P::log2r(SECOND, S);
    constexpr int LOG2NS = P::log2ns(SECOND, S);
    radix_pass<LOG2N, LOG2R, LOG2NS>(re, im, tw, t);
    if constexpr (S + 1 < P::kPasses) {
        exchange<LOG2N, LOG2R, LOG2NS, P::log2r(SECOND, S + 1)>(re, im, sre, sim, t);
        fft<LOG2N, SECOND, S + 1>(re, im, sre, sim, tw, t);
    }
}

// max |v| over the block for two rows at once; +inf if any value is not finite
template <int LOG2N>
__device__ __forceinline__ void block_max(double& ma, double& mb, double* red, int t) {
    using P = Plan<LOG2N>;
    constexpr int lanes = P::kThreads < 32 ? P::kThreads : 32;
    constexpr unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
#pragma unroll
    for (int off = lanes / 2; off > 0; off >>= 1) {
        ma = fmax(ma, __shfl_xor_sync(mask, ma, off));
        mb = fmax(mb, __shfl_xor_sync(mask, mb, off));
    }
    if constexpr (P::kWarps > 1) {
        if ((t & 31) == 0) {
            red[2 * (t >> 5)] = ma;
            red[2 * (t >> 5) + 1] = mb;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < P::kWarps; ++w) {
            ma = fmax(ma, red[2 * w]);
            mb = fmax(mb, red[2 * w + 1]);
        }
    }
}

// e from frexp(m), clamped so that 2^-e and 2^e stay normal
__device__ __forceinline__ int row_exponent(double m) {
    int e;
    frexp(m, &e);
    return max(-1000, min(1000, e));
}

template <int LOG2N>
__global__ void __launch_bounds__(Plan<LOG2N>::kThreads)
fftlog_pair_kernel(const double* __restrict__ x, double* __restrict__ out, const double2* __restrict__ u,
                   const double* __restrict__ pre, const double* __restrict__ post,
                   const double2* __restrict__ tw, int rows, int size, int in_left, int out_left,
                   int nparallel) {
    using P = Plan<LOG2N>;
    constexpr int N = P::kN, T = P::kThreads, V = P::kValues, R = P::kRadix, RL = 1 << P::kLastLog2R;
    extern __shared__ double smem[];
    double* sre = smem;
    double* sim = smem + P::kPadded;
    double* red = smem + 2 * P::kPadded;
    const int t = threadIdx.x;
    const int p = blockIdx.x % nparallel;
    const int row_a = 2 * (blockIdx.x / nparallel) * nparallel + p;
    const int row_b = row_a + nparallel;
    const bool has_b = row_b < rows;

    // zero pad and prefactor, in the places of the first pass (radix 16,
    // span 1): slot i * 16 + r holds the value at t + i * T + r * n / 16
    double re[V], im[V];
    double ma = 0.0, mb = 0.0;
    const double* xa = x + (size_t)row_a * size;
    const double* xb = x + (size_t)(has_b ? row_b : row_a) * size;
    const double* prep = pre + (size_t)p * N;
#pragma unroll
    for (int s = 0; s < V; ++s) {
        const int e = t + (s / R) * T + (s % R) * (N / R);
        const int i = e - in_left;
        const bool in = (unsigned)i < (unsigned)size;
        const double pe = in ? prep[e] : 0.0;
        re[s] = in ? pe * xa[i] : 0.0;
        im[s] = in && has_b ? pe * xb[i] : 0.0;
        ma = isfinite(re[s]) ? fmax(ma, fabs(re[s])) : CUDART_INF;
        mb = isfinite(im[s]) ? fmax(mb, fabs(im[s])) : CUDART_INF;
    }
    block_max<LOG2N>(ma, mb, red, t);
    const bool ok_a = isfinite(ma), ok_b = isfinite(mb);
    const int ea = ok_a ? row_exponent(ma) : 0, eb = ok_b ? row_exponent(mb) : 0;
    const double in_a = ldexp(1.0, -ea), in_b = ldexp(1.0, -eb);
#pragma unroll
    for (int s = 0; s < V; ++s) {
        re[s] = ok_a ? re[s] * in_a : 0.0;
        im[s] = ok_b ? im[s] * in_b : 0.0;
    }

    fft<LOG2N, false>(re, im, sre, sim, tw, t);

    // Mellin multiply, in registers: the first FFT's last pass left bin
    // k = t + i * T + r * n / RL in slot i * RL + r
    const double2* up = u + (size_t)p * (N / 2 + 1);
#pragma unroll
    for (int i = 0; i < V / RL; ++i) {
#pragma unroll
        for (int r = 0; r < RL; ++r) {
            const int k = t + i * T + r * (N / RL);
            const double2 w = __ldg(up + (k <= N / 2 ? k : N - k));
            const double wi = (k == 0 || k == N / 2) ? 0.0 : (k < N / 2 ? w.y : -w.y);
            cmul(re[i * RL + r], im[i * RL + r], w.x, wi);
        }
    }

    fft<LOG2N, true>(re, im, sre, sim, tw, t);

    // the second FFT's last pass (radix 16, span n/16) left the value at
    // m = t + i * T + r * n / 16 in slot i * 16 + r: crop, postfactor, undo the
    // row scales and the 1/n
    const double out_a = ok_a ? ldexp(1.0, ea - LOG2N) : CUDART_NAN;
    const double out_b = ok_b ? ldexp(1.0, eb - LOG2N) : CUDART_NAN;
    const double* postp = post + (size_t)p * N;
    double* oa = out + (size_t)row_a * size;
    double* ob = out + (size_t)row_b * size;
#pragma unroll
    for (int s = 0; s < V; ++s) {
        const int m = t + (s / R) * T + (s % R) * (N / R);
        const int o = m - out_left;
        if ((unsigned)o < (unsigned)size) {
            const double pm = postp[m];
            oa[o] = re[s] * out_a * pm;
            if (has_b) ob[o] = im[s] * out_b * pm;
        }
    }
}

template <int LOG2N>
int launch(const void* x, void* out, const void* u, const void* pre, const void* post, const void* tw,
           int rows, int size, int in_left, int out_left, int nparallel, cudaStream_t stream) {
    using P = Plan<LOG2N>;
    if (P::kSmem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(fftlog_pair_kernel<LOG2N>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     (int)P::kSmem);
        if (err != cudaSuccess) return (int)err;
    }
    const int pairs = (rows / nparallel + 1) / 2;
    fftlog_pair_kernel<LOG2N><<<nparallel * pairs, P::kThreads, P::kSmem, stream>>>(
        (const double*)x, (double*)out, (const double2*)u, (const double*)pre, (const double*)post,
        (const double2*)tw, rows, size, in_left, out_left, nparallel);
    return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes: rows > 0, 6 <= log2n <= 13, in_left + size <= n,
// out_left + size <= n, rows % nparallel == 0. `tw` is exp(-2 pi i k / n),
// k < n/2, as (n/2, 2) float64.
extern "C" int fftlog_core_launch(const void* x, void* out, const void* u, const void* pre,
                                  const void* post, const void* tw, int rows, int log2n,
                                  int size, int in_left, int out_left, int nparallel,
                                  void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (log2n) {
        case 6: return launch<6>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        case 7: return launch<7>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        case 8: return launch<8>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        case 9: return launch<9>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        case 10: return launch<10>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        case 11: return launch<11>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        case 12: return launch<12>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        case 13: return launch<13>(x, out, u, pre, post, tw, rows, size, in_left, out_left, nparallel, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* fftlog_core_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
