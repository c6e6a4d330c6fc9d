"""The FFTLog core as a hand-written CUDA kernel, with its plain PyTorch version.

For each row ``r`` of ``x`` (rows, size), with ``p = r % nparallel`` and the
padded length ``n``:

    f = zeros(n); f[in_left:in_left + size] = x[r]; f *= prefactor[p]
    t = irfft(conj(rfft(f) * u[p]), n) * postfactor[p]
    out[r] = t[out_left:out_left + size]

This is the contract of ``cosmoprimo_tpu/ops/pallas_fft.py::fftlog_pallas``
(exactly ``fftlog_pair_reference`` there) with the zero padding, the
prefactor and the crop fused in. :func:`fftlog_core` runs the CUDA kernel of
``csrc/fftlog_core.cu`` for CUDA tensors and :func:`fftlog_core_torch` for CPU
tensors. The kernel transforms rows ``r`` and ``r + nparallel``, which share
``u``, in one complex FFT; tests/test_torch_fftlog_packing.py holds that
algebra to this contract on the CPU.

The map ``f -> irfft(conj(rfft(f) * u))`` is a real symmetric linear
operator (its matrix depends on j + m only), so the vector-Jacobian product
of ``crop(post * T(pre * pad(x)))`` is the same transform with prefactor and
postfactor swapped and ``in_left``/``out_left`` swapped: the backward pass is
the forward kernel.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use, from the
sources in ``csrc/`` only, into ``_build/`` next to this package, keyed by a
hash of those sources. The library holds every kernel of ``csrc/``: the
spline solve (``ops/spline_kernel.py``) loads it through :func:`_library`.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from .. import tracing

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PACKAGE_DIR, 'csrc')
_BUILD_DIR = os.path.join(_PACKAGE_DIR, '_build')
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
               '-Xcompiler', '-fPIC', '-Xptxas', '-v']

MIN_LOG2N, MAX_LOG2N = 6, 13


def fftlog_core_torch(x, u, prefactor, postfactor, in_left, out_left):
    """Plain PyTorch version of the fused contract, with ``torch.fft`` in
    complex128. ``postfactor`` may be complex, and then so is the output."""
    nparallel, n = prefactor.shape
    rows, size = x.shape
    f = x.new_zeros((rows // nparallel, nparallel, n))
    f[..., in_left:in_left + size] = x.reshape(rows // nparallel, nparallel, size)
    f = f * prefactor
    t = torch.fft.irfft(torch.conj(torch.fft.rfft(f, dim=-1) * u), n=n, dim=-1) * postfactor
    return t[..., out_left:out_left + size].reshape(rows, size)


def find_nvcc():
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default location ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    candidates.append(shutil.which('nvcc'))
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels of csrc/')


def _sources():
    return sorted(os.path.join(_CSRC_DIR, name) for name in os.listdir(_CSRC_DIR)
                  if name.endswith(('.cu', '.cuh')))


def build():
    """Compile ``csrc/`` into a shared library unless a build of the same
    sources exists; returns (path, compiler output or None if cached). A
    run of nvcc counts in ``tracing.counters['fftlog_kernel.builds']``."""
    digest = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + f.read())
    lib_path = os.path.join(_BUILD_DIR, f'libfftlog_core_{digest.hexdigest()[:16]}.so')
    if os.path.exists(lib_path):
        return lib_path, None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(fd)
    cu_sources = [path for path in _sources() if path.endswith('.cu')]
    cmd = [find_nvcc()] + _NVCC_FLAGS + ['-o', tmp_path] + cu_sources
    tracing.counters['fftlog_kernel.builds'] += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n{proc.stdout}\n{proc.stderr}')
    os.replace(tmp_path, lib_path)
    return lib_path, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _library():
    """The kernel's library, built (or found built) and loaded at its first
    use; those host seconds count in ``tracing.counters['fftlog_kernel.build_s']``."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(build()[0])
    tracing.counters['fftlog_kernel.build_s'] += time.perf_counter() - t0
    lib.fftlog_core_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fftlog_core_launch.restype = ctypes.c_int
    lib.fftlog_core_error_string.argtypes = [ctypes.c_int]
    lib.fftlog_core_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _twiddles(n, device):
    """exp(-2 pi i k / n) for k < n/2, as (n/2, 2) float64 on ``device``."""
    k = np.arange(n // 2)
    tw = np.exp(-2j * np.pi * k / n)
    return torch.from_numpy(np.stack([tw.real, tw.imag], axis=-1)).to(device)


def _launch(x, u, prefactor, postfactor, in_left, out_left):
    nparallel, n = prefactor.shape
    rows, size = x.shape
    out = torch.empty((rows, size), dtype=torch.float64, device=x.device)
    if rows == 0:
        return out
    lib = _library()
    u_ri = torch.view_as_real(u)
    tw = _twiddles(n, x.device)
    with tracing.span('cosmoprimo.fftlog.kernel'):
        err = lib.fftlog_core_launch(x.data_ptr(), out.data_ptr(), u_ri.data_ptr(), prefactor.data_ptr(),
                                     postfactor.data_ptr(), tw.data_ptr(), rows, n.bit_length() - 1, size,
                                     in_left, out_left, nparallel, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fftlog_core kernel launch failed: {lib.fftlog_core_error_string(err).decode()}')
    counters = tracing.counters
    counters['fftlog.launches'] += 1
    shape = (rows, size, n, nparallel)
    counters['fftlog.shapes'][shape] = counters['fftlog.shapes'].get(shape, 0) + 1
    return out


def _check(x, u, prefactor, postfactor, in_left, out_left):
    if x.dim() != 2:
        raise ValueError(f'x must be (rows, size), got shape {tuple(x.shape)}')
    if prefactor.dim() != 2 or postfactor.shape != prefactor.shape:
        raise ValueError('prefactor and postfactor must both be (nparallel, n)')
    nparallel, n = prefactor.shape
    rows, size = x.shape
    if n & (n - 1) or not MIN_LOG2N <= n.bit_length() - 1 <= MAX_LOG2N:
        raise ValueError(f'padded length must be a power of two in [{2 ** MIN_LOG2N}, {2 ** MAX_LOG2N}], got {n}')
    if u.shape != (nparallel, n // 2 + 1):
        raise ValueError(f'u must be ({nparallel}, {n // 2 + 1}), got {tuple(u.shape)}')
    if rows % nparallel:
        raise ValueError(f'rows ({rows}) must be a multiple of nparallel ({nparallel})')
    if in_left < 0 or out_left < 0 or in_left + size > n or out_left + size > n:
        raise ValueError(f'windows [{in_left}, +{size}) and [{out_left}, +{size}) must lie in [0, {n})')
    if postfactor.is_complex():
        raise NotImplementedError('fftlog_core takes a real postfactor only: the kernel writes a real row. '
                                  'FFTlog.__call__ runs a complex postfactor as two calls, on its real and '
                                  'imaginary parts')
    for name, t, dtype in (('x', x, torch.float64), ('u', u, torch.complex128),
                           ('prefactor', prefactor, torch.float64), ('postfactor', postfactor, torch.float64)):
        if t.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _core(x, u, prefactor, postfactor, in_left, out_left):
    """The kernel on CUDA tensors, its plain version on CPU tensors; each
    call counted in ``tracing.counters`` (``fftlog.calls``), each launch in
    :func:`_launch`."""
    calls = tracing.counters['fftlog.calls']
    shape = (x.shape[0], x.shape[1], prefactor.shape[1], prefactor.shape[0])
    calls[shape] = calls.get(shape, 0) + 1
    if x.is_cuda:
        return _launch(x, u, prefactor, postfactor, in_left, out_left)
    if x.device.type != 'cpu':
        raise NotImplementedError(f'fftlog_core runs on CUDA or CPU tensors, not {x.device.type}')
    return fftlog_core_torch(x, u, prefactor, postfactor, in_left, out_left)


class _FFTLogCore(torch.autograd.Function):
    """The core as a function of ``x`` alone. It is linear in ``x``, so the
    forward-mode derivative (``jvp``) is the core applied to the tangent, the
    reverse-mode one (``backward``) the transposed core, and a vmapped call
    (``vmap``) one call over the vmapped rows folded into the row axis: each
    of them is one more launch of the same kernel on CUDA tensors."""

    @staticmethod
    def forward(x, u, prefactor, postfactor, in_left, out_left):
        return _core(x, u, prefactor, postfactor, in_left, out_left)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, u, prefactor, postfactor, in_left, out_left = inputs
        ctx.save_for_backward(u, prefactor, postfactor)
        ctx.save_for_forward(u, prefactor, postfactor)
        ctx.windows = (in_left, out_left)

    @staticmethod
    def backward(ctx, grad):
        u, prefactor, postfactor = ctx.saved_tensors
        in_left, out_left = ctx.windows
        grad_x = _FFTLogCore.apply(grad.contiguous(), u, postfactor, prefactor, out_left, in_left)
        return grad_x, None, None, None, None, None

    @staticmethod
    def jvp(ctx, x_tangent, *unused):
        u, prefactor, postfactor = ctx.saved_tensors
        return _FFTLogCore.apply(x_tangent.contiguous(), u, prefactor, postfactor, *ctx.windows)

    @staticmethod
    def vmap(info, in_dims, x, u, prefactor, postfactor, in_left, out_left):
        if any(dim is not None for dim in in_dims[1:]):
            raise NotImplementedError('fftlog_core vmaps over x only, not over u, prefactor or postfactor')
        if in_dims[0] is None:
            return _FFTLogCore.apply(x, u, prefactor, postfactor, in_left, out_left), None
        # rows % nparallel == 0, so row v * rows + r keeps r's (u, pre, post)
        x = x.movedim(in_dims[0], 0)
        rows = x.reshape(-1, x.shape[-1]).contiguous()
        out = _FFTLogCore.apply(rows, u, prefactor, postfactor, in_left, out_left)
        return out.reshape(x.shape), 0


def fftlog_core(x, u, prefactor, postfactor, in_left, out_left):
    """Fused FFTLog core (see the module docstring) for ``x`` (rows, size)
    float64, ``u`` (nparallel, n/2 + 1) complex128, ``prefactor`` and
    ``postfactor`` (nparallel, n) float64. CUDA tensors launch the kernel,
    CPU tensors take :func:`fftlog_core_torch`. Differentiable in ``x``, in
    reverse and forward mode, and vmappable over ``x``
    (``torch.autograd.forward_ad``, ``torch.func.jvp``/``jacfwd``/``vmap``).

    The postfactor must be real: the kernel writes a real row. A complex
    postfactor (``PowerToCorrelation(complex=True)``) is taken by
    :meth:`FFTlog.__call__`, which runs this core twice, on its real and its
    imaginary part; a direct call with one raises NotImplementedError."""
    _check(x, u, prefactor, postfactor, in_left, out_left)
    return _FFTLogCore.apply(x, u, prefactor, postfactor, in_left, out_left)
