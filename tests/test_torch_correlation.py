"""The port's local correlation (PDC-Net's cost volume, K7's plain version and
its two adjoints) against the JAX package, on the CPU.

K7's CUDA kernels run only on the card (``chip_smoke.py``, phase
``kernel_k7``); here CPU tensors take the plain versions, through the same
wrappers and autograd Function the matcher calls. Inputs are made with numpy
from a seed and handed to both sides. Tolerance: atol 1e-5 on values of
order 1 (fp32 sums of 8 channels in another order); 1e-4 on the gradients
of the autograd test, which are of order 3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_invertible_warp_tpu.ops.correlation import local_correlation as jax_corr
from neural_invertible_warp_tpu.ops.pallas.correlation_kernel import local_correlation_pallas
from neural_invertible_warp_tpu_torch.ops import correlation as plain
from neural_invertible_warp_tpu_torch.ops.cuda import correlation as k7

# the test workers share the cores: one intra-op thread each (ROADMAP, test time)
torch.set_num_threads(1)

SHAPE = (2, 8, 8, 16)
ATOL = 1e-5


def _maps(seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("md", [2, 4])
def test_plain_correlation_matches_jax_and_pallas(md):
    f1, f2 = _maps(md)
    ref = np.asarray(jax_corr(jnp.asarray(f1), jnp.asarray(f2), max_displacement=md))
    pallas = np.asarray(local_correlation_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                                 max_displacement=md, interpret=True))
    got = plain.local_correlation(torch.tensor(f1), torch.tensor(f2), md).numpy()
    assert got.shape == (SHAPE[0], (2 * md + 1) ** 2) + SHAPE[2:]
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    # the wrapper the matcher calls takes the plain version on CPU tensors
    wrapped = k7.local_correlation(torch.tensor(f1), torch.tensor(f2), md)
    assert torch.equal(wrapped, torch.tensor(got))
    assert k7.local_correlation.launches == 0


def test_zero_displacement_channel_is_the_mean_of_squares():
    f1, _ = _maps(7)
    x = torch.tensor(f1)
    out = k7.local_correlation(x, x, 4)
    torch.testing.assert_close(out[:, 40], (x * x).mean(dim=1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("md", [2, 4])
def test_adjoints_match_jax_vjp(md):
    """Both adjoints, plain and through the wrappers, against jax.vjp of the
    XLA twin (the JAX package's GOCor filter gradient)."""
    f1, f2 = _maps(10 + md)
    m = np.random.RandomState(20 + md).randn(
        SHAPE[0], (2 * md + 1) ** 2, *SHAPE[2:]).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_corr(a, b, max_displacement=md),
                     jnp.asarray(f1), jnp.asarray(f2))
    ref1, ref2 = (np.asarray(r) for r in vjp(jnp.asarray(m)))
    tm, t1, t2 = torch.tensor(m), torch.tensor(f1), torch.tensor(f2)
    for fn in (plain.local_correlation_transpose, k7.local_correlation_transpose):
        np.testing.assert_allclose(fn(tm, t2, md).numpy(), ref1, atol=ATOL)
    for fn in (plain.local_correlation_transpose_f2, k7.local_correlation_transpose_f2):
        np.testing.assert_allclose(fn(tm, t1, md).numpy(), ref2, atol=ATOL)
    # adjointness: <corr(f1, f2), m> = <f1, df1> = <f2, df2>
    inner = float((plain.local_correlation(t1, t2, md).double() * tm.double()).sum())
    for got, f in ((plain.local_correlation_transpose(tm, t2, md), t1),
                   (plain.local_correlation_transpose_f2(tm, t1, md), t2)):
        assert abs(float((got.double() * f.double()).sum()) - inner) <= 1e-5 * abs(inner)


def test_autograd_function_gradients_match_jax_grad():
    """_LocalCorrelation on CPU tensors: its backward (the two plain
    adjoints) against jax.grad of the same loss through the XLA twin."""
    f1, f2 = _maps(30)
    w = np.random.RandomState(31).randn(SHAPE[0], 81, *SHAPE[2:]).astype(np.float32)

    def loss_jax(a, b):
        return jnp.sum(jnp.sin(3.0 * jax_corr(a, b, max_displacement=4)) * w)
    ref1, ref2 = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))

    t1 = torch.tensor(f1, requires_grad=True)
    t2 = torch.tensor(f2, requires_grad=True)
    out = k7._LocalCorrelation.apply(t1, t2, 4)
    (torch.sin(3.0 * out) * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(ref1), atol=1e-4)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(ref2), atol=1e-4)
    # one input only: the other adjoint is not taken
    t1.grad = None
    k7.local_correlation(t1, torch.tensor(f2), 4).sum().backward()
    assert t1.grad is not None and torch.isfinite(t1.grad).all()


def test_cpu_tensors_count_no_launch():
    f1, f2 = (torch.tensor(a) for a in _maps(40))
    m = torch.zeros(SHAPE[0], 81, *SHAPE[2:])
    k7.local_correlation(f1, f2, 4)
    k7.local_correlation_transpose(m, f2, 4)
    k7.local_correlation_transpose_f2(m, f1, 4)
    assert k7.local_correlation.launches == 0
    assert k7.local_correlation_transpose.launches == 0
    assert k7.local_correlation_transpose_f2.launches == 0
