"""Parity of the port's block-tridiagonal solver (ops/block_tridiag.py) with
the JAX reference on random SPD chains: the factorisation, the solve from
its factors, the one-call solve and the dense inverse, and the inverse held
to numpy's dense one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.ops import block_tridiag as jbt
from dynosam_tpu_torch.ops import block_tridiag as tbt

torch.set_num_threads(1)


def _chain(seed, batch, F):
    """A batch of SPD block-tridiagonal matrices: (diag, upper) blocks and
    their dense form. Diagonal blocks dominate the off-diagonal coupling."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(batch + (F, 3, 3)).astype(np.float32)
    diag = (A @ np.swapaxes(A, -1, -2) + 6.0 * np.eye(3, dtype=np.float32)).astype(np.float32)
    upper = rng.standard_normal(batch + (F, 3, 3)).astype(np.float32)
    upper[..., F - 1, :, :] = 0.0
    dense = np.zeros(batch + (3 * F, 3 * F), np.float32)
    for f in range(F):
        dense[..., 3 * f:3 * f + 3, 3 * f:3 * f + 3] = diag[..., f, :, :]
        if f + 1 < F:
            dense[..., 3 * f:3 * f + 3, 3 * f + 3:3 * f + 6] = upper[..., f, :, :]
            dense[..., 3 * f + 3:3 * f + 6, 3 * f:3 * f + 3] = np.swapaxes(upper[..., f, :, :], -1, -2)
    return diag, upper, dense


CASES = [(0, (5,), 4), (1, (2, 3), 8), (2, (7,), 1)]


@pytest.mark.parametrize("seed,batch,F", CASES)
def test_factorize_and_solve(seed, batch, F):
    diag, upper, _ = _chain(seed, batch, F)
    rhs = np.random.default_rng(seed + 10).standard_normal(batch + (F, 3, 2)).astype(np.float32)
    Dr, Wr = jbt.factorize(jnp.asarray(diag), jnp.asarray(upper))
    Dt, Wt = tbt.factorize(torch.from_numpy(diag), torch.from_numpy(upper))
    # f32 recursions in the same order; 3x3 adjugate inverses of matrices
    # with entries ~10 agree to a few ulps
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wr), rtol=1e-5, atol=1e-6)
    xr = jbt.solve_factored(Dr, Wr, jnp.asarray(upper), jnp.asarray(rhs))
    xt = tbt.solve_factored(Dt, Wt, torch.from_numpy(upper), torch.from_numpy(rhs))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=1e-5, atol=1e-5)
    x1 = tbt.solve(torch.from_numpy(diag), torch.from_numpy(upper), torch.from_numpy(rhs))
    np.testing.assert_array_equal(x1.numpy(), xt.numpy())


@pytest.mark.parametrize("seed,batch,F", CASES)
def test_full_inverse(seed, batch, F):
    diag, upper, dense = _chain(seed, batch, F)
    ref = np.asarray(jbt.full_inverse(jnp.asarray(diag), jnp.asarray(upper)))
    got = tbt.full_inverse(torch.from_numpy(diag), torch.from_numpy(upper)).numpy()
    assert got.shape == batch + (F, 3, F, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # and it is the inverse: within f32 of numpy's float64 dense inverse
    inv64 = np.linalg.inv(dense.astype(np.float64)).reshape(batch + (F, 3, F, 3))
    np.testing.assert_allclose(got, inv64, rtol=1e-4, atol=1e-5)


def test_inv3_matches_reference():
    A = np.random.default_rng(3).standard_normal((16, 3, 3)).astype(np.float32)
    A[0] = 0.0  # singular: both sides divide by the eps floor
    np.testing.assert_allclose(tbt.inv3(torch.from_numpy(A)).numpy(), np.asarray(jbt.inv3(jnp.asarray(A))),
                               rtol=1e-6, atol=1e-6)
