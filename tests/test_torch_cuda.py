"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from meshdqn_tpu_torch.ops import matvec as mv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# The fused step's shapes on ys930 (2Ns = 6644, Np = 876, Ns = 3322) and on
# ah93w145 (6050, 797, 3025), whose rows are not 16-byte aligned; k = 2 is
# the (Ns, 2) velocity stack.
SHAPES = [(6644, 6644, 1), (6644, 876, 1), (876, 6644, 1), (876, 876, 1),
          (3322, 3322, 2), (6050, 6050, 1), (6050, 797, 1), (797, 6050, 1),
          (797, 797, 1), (3025, 3025, 2), (5, 3, 1), (33, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,k", SHAPES)
def test_kernels_match_plain_and_repeat_bits(cuda, R, N, k):
    g = torch.Generator(device="cpu").manual_seed(R * 7 + N + k)
    M = torch.randn(R, N, generator=g).to(cuda)
    X = torch.randn((N,) if k == 1 else (N, k), generator=g).to(cuda)
    # A draw of its own at ~2^-8 of x: dropping it moves y past the tolerance.
    lo = (2.0**-8 * X.abs().cpu() * torch.randn(X.shape, generator=g)).to(cuda)
    tol = mv.gap_tolerance(N)
    y = mv.matvec(M, X)
    assert y.shape == (R,) + tuple(X.shape[1:])
    assert torch.equal(y, mv.matvec(M, X))
    yp = mv.matvec_reference(M, X)
    assert mv.relative_gap(y, yp) <= tol
    yd = mv.matvec_dual(M, X, lo)
    assert torch.equal(yd, mv.matvec_dual(M, X, lo))
    ydp = mv.matvec_dual_reference(M, X, lo)
    assert mv.relative_gap(yd, ydp) <= tol
    # The check rejects a kernel that lost precision or dropped x_lo.
    for bits in (10, 7):
        rounded = mv.matvec_reference(mv.round_mantissa(M, bits),
                                       mv.round_mantissa(X, bits))
        assert mv.relative_gap(rounded, yp) > tol
    assert mv.relative_gap(y, ydp) > tol


@pytest.mark.cuda
def test_launches_are_counted(cuda):
    M, x = torch.ones(4, 4, device=cuda), torch.ones(4, device=cuda)
    before = mv.matvec.launches, mv.matvec_dual.launches
    mv.matvec(M, x)
    mv.matvec_dual(M, x, x)
    assert (mv.matvec.launches, mv.matvec_dual.launches) == (before[0] + 1,
                                                             before[1] + 1)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    M = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError):
        mv.matvec(M.double(), torch.zeros(8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        mv.matvec(M, torch.zeros(8, 3, device=cuda))
    with pytest.raises(ValueError):
        mv.matvec(M.T, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):
        mv.matvec(M, torch.zeros(8))
    with pytest.raises(ValueError):  # x does not fit in shared memory
        mv.matvec(torch.zeros(1, 60000, device=cuda), torch.zeros(60000, device=cuda))
