// FFTLog core for one row per thread block, in native float64 / complex128.
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
// Algorithm. With F = fft(f) and u_ext the Hermitian extension of u
// (u_ext[k] = conj(u[n - k]) for k > n/2), t = Re(ifft(conj(F * u_ext)))
// = Re(fft(F * u_ext)) / n, so both transforms are forward FFTs over one
// twiddle table exp(-2 pi i k / n), k < n/2. The row lives in shared memory as
// complex128 (n = 2048: 32 KiB). The first FFT is radix-2 decimation in time
// from a bit-reversed load (__brev), so its output is in natural order; the
// second is decimation in frequency from natural order, so its output is
// bit-reversed and the store reads it through __brev. One __syncthreads()
// separates stages.
//
// What bounds it on an H100 SXM. At the headline (40 000 rows, size 1024,
// n 2048) the kernel reads 0.33 GB and writes 0.33 GB of device memory,
// about 0.2 ms at 3.35 TB/s, and does 2 * 5 n log2(n) flops per row, about
// 9 GFLOP of f64, about 0.3 ms at the ~34 TFLOP/s f64 vector rate. A radix-2
// kernel with a barrier per stage is therefore bound by shared-memory traffic
// and by the 22 barriers, not by device memory. Later work: pack two real rows
// into one complex FFT, use a higher radix, keep the first stages in registers.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
    return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ unsigned int bitrev(unsigned int j, int log2n) {
    return __brev(j) >> (32 - log2n);
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fftlog_core_kernel(const double* __restrict__ x, double* __restrict__ out,
                   const double2* __restrict__ u, const double* __restrict__ pre,
                   const double* __restrict__ post, const double2* __restrict__ tw,
                   int log2n, int size, int in_left, int out_left, int nparallel) {
    extern __shared__ double2 buf[];
    const int n = 1 << log2n;
    const int half = n >> 1;
    const int row = blockIdx.x;
    const int p = row % nparallel;
    const double* xr = x + (size_t)row * size;
    const double* prer = pre + (size_t)p * n;
    const double* postr = post + (size_t)p * n;
    const double2* ur = u + (size_t)p * (half + 1);

    // zero pad, prefactor, bit-reversed placement
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int i = j - in_left;
        const double v = (i >= 0 && i < size) ? xr[i] * prer[j] : 0.0;
        buf[bitrev(j, log2n)] = make_double2(v, 0.0);
    }
    __syncthreads();

    // forward FFT, decimation in time: bit-reversed in, natural out
    for (int s = 0; s < log2n; ++s) {
        const int h = 1 << s;
        const int shift = log2n - 1 - s;
        for (int b = threadIdx.x; b < half; b += blockDim.x) {
            const int j = b & (h - 1);
            const int i0 = ((b >> s) << (s + 1)) + j;
            const int i1 = i0 + h;
            const double2 t = cmul(tw[j << shift], buf[i1]);
            const double2 a = buf[i0];
            buf[i0] = cadd(a, t);
            buf[i1] = csub(a, t);
        }
        __syncthreads();
    }

    // Mellin multiply by the Hermitian-extended u, and the 1/n of the inverse
    const double inv_n = 1.0 / n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        double2 uk;
        if (k <= half) {
            uk = ur[k];
        } else {
            uk = ur[n - k];
            uk.y = -uk.y;
        }
        const double2 v = cmul(buf[k], uk);
        buf[k] = make_double2(v.x * inv_n, v.y * inv_n);
    }
    __syncthreads();

    // second forward FFT, decimation in frequency: natural in, bit-reversed out
    for (int s = log2n - 1; s >= 0; --s) {
        const int h = 1 << s;
        const int shift = log2n - 1 - s;
        for (int b = threadIdx.x; b < half; b += blockDim.x) {
            const int j = b & (h - 1);
            const int i0 = ((b >> s) << (s + 1)) + j;
            const int i1 = i0 + h;
            const double2 a = buf[i0];
            const double2 c = buf[i1];
            buf[i0] = cadd(a, c);
            buf[i1] = cmul(csub(a, c), tw[j << shift]);
        }
        __syncthreads();
    }

    // real part, postfactor, crop
    double* outr = out + (size_t)row * size;
    for (int j = threadIdx.x; j < size; j += blockDim.x) {
        const int m = out_left + j;
        outr[j] = buf[bitrev(m, log2n)].x * postr[m];
    }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes: rows > 0, 6 <= log2n <= 13, in_left + size <= n,
// out_left + size <= n, rows % nparallel == 0.
extern "C" int fftlog_core_launch(const void* x, void* out, const void* u, const void* pre,
                                  const void* post, const void* tw, int rows, int log2n,
                                  int size, int in_left, int out_left, int nparallel,
                                  void* stream) {
    const size_t smem = sizeof(double2) << log2n;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(fftlog_core_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    fftlog_core_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        (const double*)x, (double*)out, (const double2*)u, (const double*)pre,
        (const double*)post, (const double2*)tw, log2n, size, in_left, out_left, nparallel);
    return (int)cudaGetLastError();
}

extern "C" const char* fftlog_core_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
