"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and nvcc, and skips without them. They
need no JAX; tests/conftest.py imports it, so on a machine without JAX run
them without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Bar: max|kernel - plain| / max|plain| <= 1e-12, forward and backward; both
are float64 FFTs of the same data in another order of operations.
"""

import numpy as np
import pytest
import torch

from cosmoprimo_tpu_torch import PowerToCorrelation, TophatVariance
from cosmoprimo_tpu_torch.ops import fftlog_kernel

BAR = 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc: the FFTLog core kernel runs only there')
    return torch.device('cuda')


def norm_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def random_core_args(rng, rows, size, n, nparallel, device):
    u = rng.normal(size=(nparallel, n // 2 + 1)) + 1j * rng.normal(size=(nparallel, n // 2 + 1))
    arrays = (rng.normal(size=(rows, size)), u, rng.normal(size=(nparallel, n)), rng.normal(size=(nparallel, n)))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize('rows,size,n,nparallel,in_left,out_left',
                         [(40000, 1024, 2048, 1, 512, 512), (30, 512, 2048, 3, 0, 0), (64, 4000, 4096, 1, 48, 48),
                          (16, 8192, 8192, 2, 0, 0), (8, 40, 64, 1, 12, 12)])
def test_fftlog_core_against_plain(cuda_device, rows, size, n, nparallel, in_left, out_left):
    rng = np.random.default_rng(rows)
    x, u, pre, post = random_core_args(rng, rows, size, n, nparallel, cuda_device)
    launches = fftlog_kernel.launches
    got = fftlog_kernel.fftlog_core(x, u, pre, post, in_left, out_left)
    ref = fftlog_kernel.fftlog_core_torch(x, u, pre, post, in_left, out_left)
    torch.cuda.synchronize()
    assert fftlog_kernel.launches == launches + 1
    assert norm_err(got, ref) <= BAR
    grad_out = torch.from_numpy(rng.normal(size=(rows, size))).to(cuda_device)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    gk, = torch.autograd.grad(fftlog_kernel.fftlog_core(xk, u, pre, post, in_left, out_left), xk, grad_out)
    gp, = torch.autograd.grad(fftlog_kernel.fftlog_core_torch(xp, u, pre, post, in_left, out_left), xp, grad_out)
    assert fftlog_kernel.launches == launches + 3  # one forward above, then forward and backward
    assert norm_err(gk, gp) <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('transform', [PowerToCorrelation, TophatVariance])
def test_transform_on_cuda_against_cpu(cuda_device, transform):
    """The 'auto' engine takes the kernel on the card and torch.fft on the
    CPU (which the JAX package holds to 1e-12 in test_torch_fftlog.py)."""
    k = np.geomspace(1e-5, 1e2, 1024)
    fun = torch.from_numpy(1e4 * (k / 0.1) ** 0.96 / (1 + (k / 0.1) ** 3) * np.random.default_rng(8).uniform(0.5, 2.0, (4, 1)))
    tr = transform(k)
    launches = fftlog_kernel.launches
    y, got = tr(fun.to(cuda_device))
    assert fftlog_kernel.launches == launches + 1
    _, ref = tr(fun)
    assert norm_err(got.cpu(), ref) <= BAR


@pytest.mark.cuda
def test_fftlog_core_rejects(cuda_device):
    rng = np.random.default_rng(9)
    x, u, pre, post = random_core_args(rng, 4, 16, 32, 1, cuda_device)
    with pytest.raises(ValueError):
        fftlog_kernel.fftlog_core(x, u, pre, post, 0, 0)   # n = 32 is below the kernel's range
    x, u, pre, post = random_core_args(rng, 4, 100, 256, 1, cuda_device)
    with pytest.raises(ValueError):
        fftlog_kernel.fftlog_core(x, u, pre.cpu(), post, 0, 0)
    with pytest.raises(NotImplementedError):
        fftlog_kernel.fftlog_core(x, u, pre, post.to(torch.complex128), 0, 0)
