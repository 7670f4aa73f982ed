"""The port's per-pixel normal-equation operators (ops/matrix_operators.py)
vs the JAX package's, and their pixel sums vs the port's channel-reduced
`hessian` / `rhs`.

Float64 on both sides (conftest turns JAX's x64 on), inputs made with numpy
from a seed; the same Jacobian fields and gradients go to both. Tolerance:
1e-9 relative (the same products, summed in another order), as
tests/test_matrix_operators.py holds the JAX operators to the JAX
`hessian` / `rhs`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.ops import matrix_operators as jmo
from inverse_compositional_algorithm_tpu_torch.ops import matrix_operators as tmo
from inverse_compositional_algorithm_tpu_torch.ops.gradients import central_gradients
from inverse_compositional_algorithm_tpu_torch.ops.normal_equations import (
    grad_moments, hessian, residual_moments, rhs,
)
from inverse_compositional_algorithm_tpu_torch.ops.transforms import (
    TransformType, jacobian_fields,
)

RTOL = 1e-9


def _setup(ttype, seed=0, b=2, h=12, w=16, c=3):
    """Port tensors (ix, iy, di, jx, jy, rho), float64."""
    rng = np.random.default_rng(seed)
    img = torch.tensor(rng.uniform(0, 255, (b, h, w, c)), dtype=torch.float64)
    di = torch.tensor(rng.normal(0, 10, (b, h, w, c)), dtype=torch.float64)
    rho = torch.tensor(rng.uniform(0.1, 1.0, (b, h, w)), dtype=torch.float64)
    ix, iy = central_gradients(img)
    jx, jy = jacobian_fields(ttype, h, w, dtype=torch.float64)
    return ix, iy, di, jx, jy, rho


def _j(t):
    return jnp.asarray(t.numpy(), jnp.float64)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("ttype", [TransformType.EUCLIDEAN, TransformType.HOMOGRAPHY])
def test_operators_match_jax(ttype):
    ix, iy, di, jx, jy, rho = _setup(ttype)
    dij = tmo.steepest_descent_images(ix, iy, jx, jy)
    jdij = jmo.steepest_descent_images(_j(ix), _j(iy), _j(jx), _j(jy))
    assert dij.shape == (*ix.shape, 8) and dij.dtype == torch.float64
    _close(dij, jdij)
    _close(tmo.ata(dij), jmo.ata(jdij))
    _close(tmo.sata(rho, dij), jmo.sata(_j(rho), jdij))
    _close(tmo.atb(dij, di), jmo.atb(jdij, _j(di)))
    _close(tmo.satb(rho, dij, di), jmo.satb(_j(rho), jdij, _j(di)))


@pytest.mark.parametrize("weighted", [False, True])
def test_pixel_sums_equal_hessian_and_rhs(weighted):
    ix, iy, di, jx, jy, rho = _setup(TransformType.HOMOGRAPHY, seed=1)
    dij = tmo.steepest_descent_images(ix, iy, jx, jy)
    gxx, gxy, gyy = grad_moments(ix, iy)
    u, v = residual_moments(ix, iy, di)
    if weighted:
        h_slow, b_slow = tmo.sata(rho, dij).sum((1, 2)), tmo.satb(rho, dij, di).sum((1, 2))
        h_fast = hessian(gxx, gxy, gyy, jx, jy, weights=rho, chunk=64)
        b_fast = rhs(u, v, jx, jy, weights=rho)
    else:
        h_slow, b_slow = tmo.ata(dij).sum((1, 2)), tmo.atb(dij, di).sum((1, 2))
        h_fast = hessian(gxx, gxy, gyy, jx, jy, chunk=64)
        b_fast = rhs(u, v, jx, jy)
    np.testing.assert_allclose(h_slow.numpy(), h_fast.numpy(), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(b_slow.numpy(), b_fast.numpy(), rtol=RTOL, atol=1e-6)
