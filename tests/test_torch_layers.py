"""The port's reference-signature shims (models/layers.py) vs the JAX
package's, on the CPU.

Each of the three classes and three functional mirrors gets the same
`synth_pair` (tests/conftest.py: I1 = a smooth image sampled at the ground
truth, I2 = the image, so the solver's fixed point is the ground truth),
made with numpy, float32 on both sides. Tolerances are those of
tests/test_torch_align.py::test_align_matches_jax: p within 1e-2 px of
corner displacement of the JAX result and of the ground truth (float32
solves whose sums run in another order), the same valid mask, and Iw
within 0.05 on it (0..255 images).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.models import layers as jl
from inverse_compositional_algorithm_tpu.ops.transforms import (
    TransformType as JT, pad_params, transform_points,
)
from inverse_compositional_algorithm_tpu_torch.models import layers as tl
from inverse_compositional_algorithm_tpu_torch.ops.normal_equations import RobustLoss as TR
from inverse_compositional_algorithm_tpu_torch.ops.transforms import TransformType as TT

torch.set_num_threads(1)

CORNER_TOL = 1e-2
IW_ATOL = 0.05
P_GT = [1.2, -0.8, 0.015]    # EUCLIDEAN: a few px at the corners


def corner_err(pa, pb, ttype_name, h, w):
    ttype = JT[ttype_name]
    xs = jnp.asarray([0.0, w - 1.0, 0.0, w - 1.0], jnp.float64)
    ys = jnp.asarray([0.0, 0.0, h - 1.0, h - 1.0], jnp.float64)
    pa = pad_params(jnp.asarray(np.asarray(pa), jnp.float64), ttype)
    pb = pad_params(jnp.asarray(np.asarray(pb), jnp.float64), ttype)
    ax, ay = transform_points(pa, ttype, xs, ys)
    bx, by = transform_points(pb, ttype, xs, ys)
    return float(jnp.max(jnp.hypot(ax - bx, ay - by)))


def _shims(name):
    """(port callable, JAX callable) of shim `name`, each taking (I1, I2, p0)."""
    if name == "InverseCompositional":
        port = tl.InverseCompositional(transform_type=TT.EUCLIDEAN, device="cpu")
        jax_ = jl.InverseCompositional(transform_type=JT.EUCLIDEAN)
        return (lambda a, b, p: port((a, b, p))), (lambda a, b, p: jax_((a, b, p)))
    if name == "RobustInverseCompositional":
        port = tl.RobustInverseCompositional(transform_type=TT.EUCLIDEAN, device="cpu")
        jax_ = jl.RobustInverseCompositional(transform_type=JT.EUCLIDEAN)
        return (lambda a, b, p: port((a, b, p))), (lambda a, b, p: jax_((a, b, p)))
    if name == "PyramidalInverseCompositional":
        port = tl.PyramidalInverseCompositional(transform_type=TT.EUCLIDEAN, device="cpu")
        jax_ = jl.PyramidalInverseCompositional(transform_type=JT.EUCLIDEAN)
        return (lambda a, b, p: port((a, b))), (lambda a, b, p: jax_((a, b)))
    port_fn, jax_fn = getattr(tl, name), getattr(jl, name)
    return ((lambda a, b, p: port_fn(a, b, p, TT.EUCLIDEAN, device="cpu")),
            (lambda a, b, p: jax_fn(a, b, p, JT.EUCLIDEAN)))


@pytest.mark.parametrize("name", [
    "InverseCompositional", "RobustInverseCompositional", "PyramidalInverseCompositional",
    "inverse_compositional_algorithm", "robust_inverse_compositional_algorithm",
    "pyramidal_inverse_compositional_algorithm",
])
def test_layer_matches_jax(make_pair, name):
    i1, i2 = make_pair(P_GT, JT.EUCLIDEAN)
    h, w = i1.shape[:2]
    p0 = np.zeros(3, np.float32)
    port, jax_ = _shims(name)
    p, err, di, iw = port(i1, i2, p0)
    jp, jerr, jdi, jiw = jax_(i1, i2, p0)
    assert tuple(p.shape) == (3,) and p.dtype == torch.float32
    assert tuple(iw.shape) == tuple(di.shape) == (h, w, 3) and err.ndim == 0
    assert corner_err(p.numpy(), jp, "EUCLIDEAN", h, w) <= CORNER_TOL
    assert corner_err(p.numpy(), P_GT, "EUCLIDEAN", h, w) <= CORNER_TOL
    fin, jfin = np.isfinite(iw.numpy()), np.isfinite(np.asarray(jiw))
    np.testing.assert_array_equal(fin, jfin)
    np.testing.assert_allclose(iw.numpy()[fin], np.asarray(jiw)[jfin], atol=IW_ATOL)
    np.testing.assert_allclose(di.numpy()[fin], np.asarray(jdi)[jfin], atol=IW_ATOL)


def test_layer_keeps_its_config():
    layer = tl.RobustInverseCompositional(TOL=5e-4, robust_type=TR.LORENTZIAN, lambda_=3.0,
                                          delta=4, device="cpu")
    cfg = layer.cfg
    assert (cfg.tol, cfg.robust, cfg.lam, cfg.delta, cfg.nscales) == (5e-4, TR.LORENTZIAN,
                                                                      3.0, 4, 1)
    assert layer.device == "cpu"
