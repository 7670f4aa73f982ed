"""Plain versions of the port's kernels (K1 fused iteration, K3 warp, K4
moments) vs the JAX package's Pallas kernels.

Float32 on both sides, inputs made with numpy from a seed. Where a case
runs the Pallas kernel it runs it in interpret mode, as the JAX package's
own tests do; the remaining cases hold the port against the JAX op chain
that the kernel replaces (tests/test_fused_iter.py:67-78), which is the
Pallas kernels' own oracle. Tolerances are those of the JAX kernel tests:
moments and normal equations normalized by max(|ref|, 1) at atol 2e-4,
warps of 0..255 images at atol 2e-3 (float32 summation order).

The same kernels on a CUDA device are tested in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.ops import normal_equations as jne
from inverse_compositional_algorithm_tpu.ops import transforms as jtr
from inverse_compositional_algorithm_tpu.ops.gradients import (
    boundary_band_mask as j_band,
    central_gradients as j_grad,
)
from inverse_compositional_algorithm_tpu.ops.pallas import fused_iter as jfi
from inverse_compositional_algorithm_tpu.ops.pallas import normal_eq as jnq
from inverse_compositional_algorithm_tpu.ops.pallas import warp as jpw
from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample as j_sample
from inverse_compositional_algorithm_tpu.ops.warp import domain_mask as j_domain
from inverse_compositional_algorithm_tpu.models.ic import _masked_residual as j_masked
from inverse_compositional_algorithm_tpu_torch.ops import gradients as tgr
from inverse_compositional_algorithm_tpu_torch.ops import normal_equations as tne
from inverse_compositional_algorithm_tpu_torch.ops import transforms as ttr
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as tfi
from inverse_compositional_algorithm_tpu_torch.ops.kernels import normal_eq as tnq
from inverse_compositional_algorithm_tpu_torch.ops.kernels import warp as tkw

torch.set_num_threads(1)

MOM_TOL = 2e-4
WARP_TOL = 2e-3
T = ttr.TransformType
R = tne.RobustLoss
F32 = jnp.float32


def t32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def normalized_close(got, ref, atol=MOM_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    n = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / n, ref / n, rtol=0, atol=atol)


def grids(ttype, p, b, h, w):
    """numpy float32 (gx, gy) [b, h, w] of the JAX transform_grid."""
    pp = jnp.broadcast_to(jtr.pad_params(jnp.asarray(p, F32)), (b, 8))
    gx, gy = jtr.transform_grid(pp, jtr.TransformType[ttype.name], h, w)
    return np.asarray(gx), np.asarray(gy)


# ---- K3: warp ----

def _image(b, h, w, c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (b, h, w, c)).astype(np.float32)


WARP_CASES = [
    (T.TRANSLATION, [3.25, -2.5]),
    (T.TRANSLATION, [-11.0, 7.75]),
    (T.HOMOGRAPHY, [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5]),
    (T.EUCLIDEAN, [1.5, -0.5, 0.05]),
    (T.EUCLIDEAN, [0.0, 0.0, -0.12]),
    (T.SIMILARITY, [0.5, 1.0, 0.04, -0.06]),
    (T.AFFINITY, [1.0, -1.0, 0.05, -0.02, 0.08, -0.04]),
]


@pytest.mark.parametrize("ttype,p", WARP_CASES, ids=[f"{t.name}-{i}" for i, (t, _) in
                                                     enumerate(WARP_CASES)])
def test_warp_planar_matches_pallas(ttype, p):
    img = _image(2, 37, 53)
    gx, gy = grids(ttype, p, 2, 37, 53)
    want = jpw.pallas_warp_planar(jpw.pad_planar(jnp.asarray(img)), jnp.asarray(gx),
                                  jnp.asarray(gy), 37, 53, interpret=True)
    got = tkw.warp_planar(t32(img).permute(0, 3, 1, 2).contiguous(), t32(gx), t32(gy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=WARP_TOL)


def _hard_grids():
    """[2, 64, 200] grids: a 69-degree rotation and a diverged homography
    whose denominator crosses zero (coordinates up to +-1e5 and inf)."""
    rx, ry = grids(T.EUCLIDEAN, [0.0, 0.0, 1.2], 1, 64, 200)
    hx, hy = grids(T.HOMOGRAPHY, [-1.2, -2.5, 33.0, 0.04, -3.3, 26.0, 1.5e-3, -0.1],
                   1, 64, 200)
    sx, sy = grids(T.EUCLIDEAN, [1.0, 2.0, 0.01], 1, 64, 200)
    return (np.concatenate([rx, hx]), np.concatenate([ry, hy]),
            np.concatenate([sx, rx]), np.concatenate([sy, ry]))


@pytest.mark.parametrize("case", ["rotation+diverged", "mixed"])
def test_warp_planar_hard_motion_matches_pallas(case):
    img = _image(2, 64, 200, seed=1)
    rx, ry, mx, my = _hard_grids()
    gx, gy = (rx, ry) if case == "rotation+diverged" else (mx, my)
    want = np.asarray(jpw.pallas_warp_planar(
        jpw.pad_planar(jnp.asarray(img)), jnp.asarray(gx), jnp.asarray(gy), 64, 200,
        interpret=True))
    got = tkw.warp_planar(t32(img).permute(0, 3, 1, 2).contiguous(), t32(gx), t32(gy)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_TOL, equal_nan=True)
    if case == "rotation+diverged":
        assert 0 < np.isnan(got[1]).mean() < 0.05 and not np.isnan(got[0]).any()


def test_warp_image_fast_matches_warp_image():
    img = _image(2, 37, 53, seed=2)
    gx, gy = grids(T.EUCLIDEAN, [1.5, -0.5, 0.05], 2, 37, 53)
    iw, valid = tkw.warp_image_fast(t32(img), t32(img).permute(0, 3, 1, 2).contiguous(),
                                    t32(gx), t32(gy), delta=5)
    ref = j_sample(jnp.asarray(img), jnp.asarray(gx), jnp.asarray(gy))
    np.testing.assert_allclose(iw.numpy(), np.asarray(ref), rtol=0, atol=WARP_TOL)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(j_domain(jnp.asarray(gx), jnp.asarray(gy),
                                                      37, 53, 5)))


# ---- K4: moments ----

@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    b, h, w = 2, 21, 37
    gx, gy, r = (rng.normal(size=(b, h, w)) for _ in range(3))
    return np.stack([gx * gx, gx * gy, gy * gy, gx * r, gy * r], axis=1).astype(np.float32)


def test_weighted_moments_matches_pallas(maps):
    want = np.asarray(jnq.weighted_moments(jnp.asarray(maps), tile_h=8, interpret=True))
    got = tnq.weighted_moments(t32(maps)).numpy()
    normalized_close(got, want)
    assert (got[:, :, 5:, :] == 0).all() and (got[:, :, :, 5:] == 0).all()


@pytest.mark.parametrize("ttype", list(T), ids=[t.name for t in T])
def test_fused_normal_eq_matches_xla(maps, ttype):
    """Assembled H and r against the JAX XLA normal equations (float64
    oracle, as tests/test_pallas_normal_eq.py)."""
    b, _, h, w = maps.shape
    jtt = jtr.TransformType[ttype.name]
    s = jtr.param_preconditioner(jtt, h, w)
    jx, jy = jtr.jacobian_fields(jtt, h, w, dtype=jnp.float64, scale=s)
    m64 = [jnp.asarray(maps[:, k], jnp.float64) for k in range(5)]
    h_ref = np.asarray(jne.hessian(*m64[:3], jx, jy))
    b_ref = np.asarray(jne.rhs(m64[3], m64[4], jx, jy))
    hh, bb = tnq.fused_normal_eq(*(t32(maps[:, k]) for k in range(5)), ttype=ttype)
    np.testing.assert_allclose(hh.numpy(), h_ref, rtol=0, atol=MOM_TOL * np.abs(h_ref).max())
    np.testing.assert_allclose(bb.numpy(), b_ref, rtol=0, atol=MOM_TOL * np.abs(b_ref).max())
    h_only = tnq.fused_hessian(*(t32(maps[:, k]) for k in range(3)), ttype=ttype)
    b_only = tnq.fused_rhs(t32(maps[:, 3]), t32(maps[:, 4]), ttype=ttype)
    np.testing.assert_allclose(h_only.numpy(), hh.numpy(), rtol=1e-6)
    np.testing.assert_allclose(b_only.numpy(), bb.numpy(), rtol=1e-6)


# ---- K1: fused iteration ----

def _setup(ttype, p, b=2, h=37, w=53, c=3, delta=4, seed=0):
    """The inputs of tests/test_fused_iter.py::_setup, as numpy float32:
    the JAX side samples at JAX transform_grid's (gx, gy), the port's K1
    forms them from the motion matrix of p."""
    rng = np.random.default_rng(seed)
    i2 = rng.uniform(0, 255, (b, h, w, c)).astype(np.float32)
    i1 = rng.uniform(0, 255, (b, h, w, c)).astype(np.float32)
    gx, gy = grids(ttype, p, b, h, w)
    return dict(i1=i1, i2=i2, gx=gx, gy=gy, p=p, h=h, w=w, delta=delta, ttype=ttype)


def _motion(e, b):
    """(the port's [b, 3, 3] float32 motion matrices of e's p, projective)."""
    pp = ttr.pad_params(t32(np.asarray(e["p"], np.float32))).expand(b, 8)
    return ttr.params_to_matrix(pp, e["ttype"]), e["ttype"] is T.HOMOGRAPHY


def _port_moments(e, robust, lam, nanifoutside=True):
    i1 = t32(e["i1"])
    ix, iy = tgr.central_gradients(i1)
    band = tgr.boundary_band_mask(e["h"], e["w"], e["delta"])[None, ..., None]
    ix, iy = ix * band, iy * band
    plan = tfi.plan_fused_iter(i1, t32(e["i2"]), ix, iy, *tne.grad_moments(ix, iy),
                               robust=True)
    return tfi.fused_iter_moments(plan.i2p, plan.tplp, *_motion(e, i1.shape[0]),
                                  torch.full((i1.shape[0],), float(lam)), e["h"], e["w"],
                                  robust, nanifoutside, e["delta"])


def _jax_template(e):
    i1 = jnp.asarray(e["i1"])
    ix, iy = j_grad(i1)
    band = j_band(e["h"], e["w"], e["delta"]).astype(F32)[None, ..., None]
    ix, iy = ix * band, iy * band
    return i1, ix, iy, jne.grad_moments(ix, iy)


def _jax_pallas_moments(e, robust, lam):
    i1, ix, iy, g = _jax_template(e)
    plan = jfi.plan_fused_iter(i1, jnp.asarray(e["i2"]), ix, iy, *g, robust=True)
    return np.asarray(jfi.fused_iter_moments(
        plan.i2p, plan.tplp, jnp.asarray(e["gx"]), jnp.asarray(e["gy"]), F32(lam),
        height=e["h"], width=e["w"], robust=robust, nanifoutside=True,
        delta=e["delta"], interpret=True))


def _jax_oracle(e, robust, lam, nanifoutside=True):
    """H, b of the JAX op chain (tests/test_fused_iter.py::_oracle)."""
    i1, ix, iy, g = _jax_template(e)
    gx, gy = jnp.asarray(e["gx"]), jnp.asarray(e["gy"])
    iw = j_sample(jnp.asarray(e["i2"]), gx, gy)
    di = j_masked(iw, j_domain(gx, gy, e["h"], e["w"], e["delta"]), i1, nanifoutside)
    jtt = jtr.TransformType[e["ttype"].name]
    jx, jy = jtr.jacobian_fields(jtt, e["h"], e["w"], dtype=F32,
                                 scale=jtr.param_preconditioner(jtt, e["h"], e["w"]))
    rho = (jne.robust_weights(di, F32(lam), jne.RobustLoss[robust.name])
           if robust is not None else None)
    u, v = jne.residual_moments(ix, iy, di)
    return (np.asarray(jne.hessian(*g, jx, jy, weights=rho)),
            np.asarray(jne.rhs(u, v, jx, jy, weights=rho)))


def _assembled(e, m, robust):
    ttype = e["ttype"]
    if robust is None:
        return None, tnq._assemble_b(m, ttype, e["h"], e["w"]).numpy()
    return (tnq._assemble_h(m[:, :3], ttype, e["h"], e["w"]).numpy(),
            tnq._assemble_b(m[:, 3:], ttype, e["h"], e["w"]).numpy())


K1_CASES = [
    (T.TRANSLATION, [3.25, -2.5]),
    (T.EUCLIDEAN, [1.5, -0.5, 0.05]),
    (T.AFFINITY, [1.0, -1.0, 0.05, -0.02, 0.08, -0.04]),
    (T.HOMOGRAPHY, [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5]),
]


@pytest.mark.parametrize("ttype,p", K1_CASES, ids=[t.name for t, _ in K1_CASES])
def test_fused_iter_matches_pallas(ttype, p):
    e = _setup(ttype, p)
    want = _jax_pallas_moments(e, jne.RobustLoss.CHARBONNIER, 5.0)
    got = _port_moments(e, R.CHARBONNIER, 5.0).numpy()
    normalized_close(got, want)


@pytest.mark.parametrize("robust,lam,nan,rotate", [
    (R.TRUNCATED_QUADRATIC, 17.0, True, False),
    (R.GERMAN_MCCLURE, 17.0, True, False),
    (R.LORENTZIAN, 17.0, True, False),
    (R.CHARBONNIER, 5.0, False, False),
    (None, 0.0, True, False),
    (R.CHARBONNIER, 5.0, True, True),
], ids=["truncated", "german_mcclure", "lorentzian", "nanifoutside_false", "quadratic",
        "extreme_rotation"])
def test_fused_iter_matches_op_chain(robust, lam, nan, rotate):
    if rotate:     # ~69 degrees: taps of one row span many image rows
        e = _setup(T.EUCLIDEAN, [0.0, 0.0, 1.2], h=64, w=200)
    elif nan:
        e = _setup(T.EUCLIDEAN, [1.5, -0.5, 0.05], seed=3)
    else:
        e = _setup(T.TRANSLATION, [9.0, -7.0], seed=2)
    h_ref, b_ref = _jax_oracle(e, robust, lam, nan)
    h_got, b_got = _assembled(e, _port_moments(e, robust, lam, nan), robust)
    normalized_close(b_got, b_ref)
    if robust is not None:
        normalized_close(h_got, h_ref)


def test_fused_iter_per_pair_lambda_and_y_offset():
    """lam per pair equals one call per pair; y_offset shifts the grid's
    rows, and so the coordinates and the y powers, as transform_grid and
    the plain moments with global rows do."""
    e = _setup(T.HOMOGRAPHY, K1_CASES[3][1], seed=4)
    i1 = t32(e["i1"])
    ix, iy = tgr.central_gradients(i1)
    plan = tfi.plan_fused_iter(i1, t32(e["i2"]), ix, iy, *tne.grad_moments(ix, iy))
    mat, proj = _motion(e, 2)
    args = (plan.i2p, plan.tplp, mat)
    both = tfi.fused_iter_moments(*args, proj, torch.tensor([5.0, 40.0]), 37, 53,
                                  R.CHARBONNIER, True, 4, y_offset=6)
    for k, lam in enumerate([5.0, 40.0]):
        one = tfi.fused_iter_moments(*(a[k:k + 1] for a in args), proj, torch.tensor([lam]),
                                     37, 53, R.CHARBONNIER, True, 4, y_offset=6)
        np.testing.assert_allclose(both[k:k + 1].numpy(), one.numpy(), rtol=1e-6)
    no_off = tfi.fused_iter_moments(*args, proj, torch.tensor([5.0, 40.0]), 37, 53,
                                    R.CHARBONNIER, True, 4)
    assert not np.allclose(both.numpy(), no_off.numpy())
    # Row bands with global rows add up to the frame: the band's coordinates
    # and y powers both start at its y_offset.
    lam = torch.tensor([5.0, 40.0])
    full = tfi.fused_iter_moments(*args, proj, lam, 37, 53, R.CHARBONNIER, True, 4)
    top = tfi.fused_iter_moments(plan.i2p, plan.tplp[:, :, :6].contiguous(), mat, proj, lam,
                                 37, 53, R.CHARBONNIER, True, 4)
    rest = tfi.fused_iter_moments(plan.i2p, plan.tplp[:, :, 6:].contiguous(), mat, proj, lam,
                                  37, 53, R.CHARBONNIER, True, 4, y_offset=6)
    normalized_close((top + rest).numpy(), full.numpy())


@pytest.mark.parametrize("y_offset", [0, 5])
@pytest.mark.parametrize("ttype,p", K1_CASES, ids=[t.name for t, _ in K1_CASES])
def test_fused_iter_ref_coordinates_are_transform_grid(ttype, p, y_offset):
    """Float64: the plain K1's coordinates (matrix_grid of the motion
    matrix) are the port's transform_grid bit for bit and JAX's
    transform_grid to 1e-9, with and without a row offset."""
    pp = ttr.pad_params(torch.tensor([p, [-v for v in p]], dtype=torch.float64))
    gx, gy = ttr.matrix_grid(ttr.params_to_matrix(pp, ttype), ttype is T.HOMOGRAPHY, 9, 13,
                             y_offset)
    tx, ty = ttr.transform_grid(pp, ttype, 9, 13, y_offset=y_offset)
    assert gx.dtype == torch.float64
    np.testing.assert_array_equal(gx.numpy(), tx.numpy())
    np.testing.assert_array_equal(gy.numpy(), ty.numpy())
    jx, jy = jtr.transform_grid(jnp.asarray(pp.numpy()), jtr.TransformType[ttype.name], 9, 13,
                                y_offset=y_offset)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), rtol=0, atol=1e-9)


def test_fused_iter_rejects_bad_plans():
    e = _setup(T.TRANSLATION, [1.0, 1.0])
    i1 = t32(e["i1"])
    ix, iy = tgr.central_gradients(i1)
    quad = tfi.plan_fused_iter(i1, t32(e["i2"]), ix, iy, *tne.grad_moments(ix, iy),
                               robust=False)
    assert quad.tplp.shape[1] == 9
    with pytest.raises(ValueError):
        tfi.fused_iter_moments(quad.i2p, quad.tplp, *_motion(e, 2), 5.0,
                               37, 53, R.CHARBONNIER, True, 4)
    with pytest.raises(ValueError):
        tfi.fused_iter_moments(quad.i2p, quad.tplp, _motion(e, 2)[0].to("meta"), False, 5.0,
                               37, 53, None, True, 4)
    with pytest.raises(ValueError):
        tkw.warp_planar(quad.i2p, t32(e["gx"]).to("meta"), t32(e["gy"]))
