"""The port's CPU path vs the native C++ engine (native/libica_cpu.so
through the JAX package's native_bridge.py, which is framework-free and
reused, not ported): two independent implementations must agree.

The cases and tolerances are tests/test_native.py's, which holds the JAX
package to the same engine: warps of 0..255 images at atol 2e-3 with the
same NaN positions, gradients at 1e-4, the normal equations at rtol 1e-5
(float32 maps, float64 sums on both sides), and complete single-pair
solves within 5e-3 of the ground truth and of the port's `ic_solve`
(float64 here, the engine's accumulation type). Inputs are made with numpy
from a seed. Every test skips where the native library is not built.
"""

import numpy as np
import pytest
import torch

from inverse_compositional_algorithm_tpu import native_bridge as nb
from inverse_compositional_algorithm_tpu_torch.models.ic import ic_solve
from inverse_compositional_algorithm_tpu_torch.ops.gradients import central_gradients
from inverse_compositional_algorithm_tpu_torch.ops.normal_equations import (
    RobustLoss, hessian, rhs,
)
from inverse_compositional_algorithm_tpu_torch.ops.transforms import (
    TransformType, jacobian_fields, pad_params,
)
from inverse_compositional_algorithm_tpu_torch.ops.warp import warp_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def native():
    if not nb.available():
        pytest.skip("native library not built")


@pytest.mark.parametrize("ttype,p", [
    (TransformType.TRANSLATION, [1.7, -0.8]),
    (TransformType.EUCLIDEAN, [1.0, 0.5, 0.03]),
    (TransformType.HOMOGRAPHY, [0.01, 0.002, 1.5, -0.001, 0.004, 0.7, 1e-5, -2e-5]),
])
def test_warp_matches_native(ttype, p):
    img = np.random.default_rng(0).uniform(0, 255, (33, 47, 3)).astype(np.float32)
    p8 = np.zeros(8)
    p8[:len(p)] = p
    native = nb.warp_bicubic(img, p8, ttype.value, nanifoutside=True, delta=3)
    iw, valid = warp_image(torch.tensor(img)[None],
                           pad_params(torch.tensor(p8, dtype=torch.float32))[None], ttype,
                           delta=3)
    port = np.where(valid[0, ..., None].numpy(), iw[0].numpy(), np.nan)
    mask = np.isfinite(native)
    np.testing.assert_array_equal(mask, np.isfinite(port))
    np.testing.assert_allclose(port[mask], native[mask], atol=2e-3)


def test_gradients_match_native():
    img = np.random.default_rng(1).uniform(0, 255, (21, 17, 3)).astype(np.float32)
    nix, niy = nb.gradients(img)
    ix, iy = central_gradients(torch.tensor(img)[None])
    np.testing.assert_allclose(ix[0].numpy(), nix, atol=1e-4)
    np.testing.assert_allclose(iy[0].numpy(), niy, atol=1e-4)


@pytest.mark.parametrize("ttype", [TransformType.EUCLIDEAN, TransformType.HOMOGRAPHY])
def test_normal_eq_matches_native(ttype):
    rng = np.random.default_rng(2)
    h, w = 19, 23
    gx, gy, r = (rng.normal(size=(h, w)).astype(np.float32) for _ in range(3))
    w1, w2, w3, wu, wv = gx * gx, gx * gy, gy * gy, gx * r, gy * r
    hn, bn = nb.normal_eq(w1, w2, w3, wu, wv, ttype.value)
    jx, jy = jacobian_fields(ttype, h, w, dtype=torch.float64)

    def t64(a):
        return torch.tensor(a, dtype=torch.float64)[None]

    hp = hessian(t64(w1), t64(w2), t64(w3), jx, jy)
    bp = rhs(t64(wu), t64(wv), jx, jy)
    np.testing.assert_allclose(hp[0].numpy(), hn, rtol=1e-5)
    np.testing.assert_allclose(bp[0].numpy(), bn, rtol=1e-5)


@pytest.mark.parametrize("ttype,gt,robust", [
    (TransformType.TRANSLATION, [2.5, -1.75], 0),
    (TransformType.EUCLIDEAN, [1.0, -0.5, 0.02], 4),      # CHARBONNIER
    (TransformType.SIMILARITY, [0.5, -1.0, 0.01, -0.008], 0),
    (TransformType.AFFINITY, [1.0, 0.5, 0.01, -0.005, 0.004, -0.01], 0),
    (TransformType.HOMOGRAPHY, [0.008, -0.004, 1.0, 0.005, -0.006, -0.75, 1e-6, -5e-7], 3),
], ids=["translation", "euclidean", "similarity", "affinity", "homography"])
def test_ic_solve_matches_native(make_pair, ttype, gt, robust):
    from inverse_compositional_algorithm_tpu.ops.transforms import TransformType as JT

    i1, i2 = make_pair(gt, JT[ttype.name])
    p_nat, err, nit = nb.solve(i1, i2, np.zeros(8), ttype.value, robust_value=robust, delta=5)
    s = ic_solve(torch.tensor(i1, dtype=torch.float64)[None],
                 torch.tensor(i2, dtype=torch.float64)[None],
                 torch.zeros((1, 8), dtype=torch.float64), ttype, delta=5,
                 robust=RobustLoss(robust))
    k = len(gt)
    assert nit >= 2 and err < 1e-3
    np.testing.assert_allclose(p_nat[:k], gt, atol=5e-3)
    np.testing.assert_allclose(s.p[0, :k].numpy(), p_nat[:k], atol=5e-3)
