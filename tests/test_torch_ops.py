"""PyTorch port vs the JAX package: sampling, gradients, normal equations,
pyramid, the moment-assembly tensors and the solver helpers.

Float64 on both sides with inputs made with numpy from a seed; atol 1e-9
(same formulas, float64, only the summation order may differ), scaled by
the magnitude of the values where they are large sums (noted per test).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.models import ic as jic
from inverse_compositional_algorithm_tpu.ops import gradients as jgr
from inverse_compositional_algorithm_tpu.ops import normal_equations as jne
from inverse_compositional_algorithm_tpu.ops import pyramid as jpy
from inverse_compositional_algorithm_tpu.ops import transforms as jtr
from inverse_compositional_algorithm_tpu.ops import warp as jwa
from inverse_compositional_algorithm_tpu.ops.pallas import normal_eq as jnq
from inverse_compositional_algorithm_tpu_torch.models import ic as tic
from inverse_compositional_algorithm_tpu_torch.ops import gradients as tgr
from inverse_compositional_algorithm_tpu_torch.ops import normal_equations as tne
from inverse_compositional_algorithm_tpu_torch.ops import pyramid as tpy
from inverse_compositional_algorithm_tpu_torch.ops import transforms as ttr
from inverse_compositional_algorithm_tpu_torch.ops import warp as twa
from inverse_compositional_algorithm_tpu_torch.ops.kernels import normal_eq as tnq

torch.set_num_threads(1)

ATOL = 1e-9
T = ttr.TransformType
R = tne.RobustLoss
MODELS = list(T)
IDS = [t.name for t in T]


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol,
                               equal_nan=True)


def images(b=2, h=21, w=29, c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (b, h, w, c))


def homography(b=2):
    return np.tile([0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5], (b, 1))


# ---- sampling ----

def test_keys_weights():
    t = np.linspace(0.0, 0.999, 37)
    for a, b in zip(twa.keys_cubic_weights(torch.tensor(t)),
                    jwa.keys_cubic_weights(jnp.asarray(t))):
        close(a, b)


@pytest.mark.parametrize("out_shape", [(21, 29), (11, 40)])
def test_bicubic_sample(out_shape):
    img = images()
    rng = np.random.default_rng(1)
    gx = rng.uniform(-5, 34, (2, *out_shape))
    gy = rng.uniform(-5, 26, (2, *out_shape))
    close(twa.bicubic_sample(torch.tensor(img), torch.tensor(gx), torch.tensor(gy)),
          jwa.bicubic_sample(jnp.asarray(img), jnp.asarray(gx), jnp.asarray(gy)))


def test_bicubic_sample_diverged_homography():
    """Coordinates swing to +-1e5 and +-inf; NaN where both samplers give NaN.
    Values up to ~1e2 * 255 at the far taps: atol 1e-9 relative to 255."""
    img = images(1, 64, 200)
    p = np.array([[-1.2, -2.5, 33.0, 0.04, -3.3, 26.0, 1.5e-3, -0.1]])
    gx, gy = jtr.transform_grid(jnp.asarray(p), jtr.TransformType.HOMOGRAPHY, 64, 200)
    got = twa.bicubic_sample(torch.tensor(img), torch.tensor(np.asarray(gx)),
                             torch.tensor(np.asarray(gy)))
    want = jwa.bicubic_sample(jnp.asarray(img), gx, gy)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    close(got, want, atol=ATOL * 255)


@pytest.mark.parametrize("ttype", MODELS, ids=IDS)
def test_warp_image(ttype):
    img = images(seed=2)
    p = np.zeros((2, 8))
    p[:, :ttype.n] = {T.TRANSLATION: [1.25, -0.5], T.EUCLIDEAN: [1.0, 0.5, 0.03],
                      T.SIMILARITY: [0.5, 1.0, 0.04, -0.06],
                      T.AFFINITY: [1.0, -1.0, 0.05, -0.02, 0.08, -0.04],
                      T.HOMOGRAPHY: homography()[0]}[ttype]
    iw_t, v_t = twa.warp_image(torch.tensor(img), torch.tensor(p), ttype, delta=3)
    iw_j, v_j = jwa.warp_image(jnp.asarray(img), jnp.asarray(p),
                               jtr.TransformType[ttype.name], delta=3)
    close(iw_t, iw_j)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


# ---- gradients ----

def test_central_gradients():
    img = images(seed=3)
    for a, b in zip(tgr.central_gradients(torch.tensor(img)),
                    jgr.central_gradients(jnp.asarray(img))):
        close(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(y_offset=5, full_height=40)])
def test_boundary_band_mask(kw):
    np.testing.assert_array_equal(tgr.boundary_band_mask(17, 23, 4, **kw).numpy(),
                                  np.asarray(jgr.boundary_band_mask(17, 23, 4, **kw)))


# ---- normal equations ----

@pytest.mark.parametrize("loss", list(R), ids=[l.name for l in R])
def test_rhop_and_weights(loss):
    rng = np.random.default_rng(4)
    di = rng.normal(scale=20.0, size=(2, 7, 9, 3))
    lam = np.array([5.0, 17.0])[:, None, None]
    close(tne.robust_weights(torch.tensor(di), torch.tensor(lam), loss),
          jne.robust_weights(jnp.asarray(di), jnp.asarray(lam), jne.RobustLoss[loss.name]))
    t2 = np.array([0.0, 1.0, 24.9, 25.0, 400.0])
    close(tne.rhop(torch.tensor(t2), 5.0, loss), jne.rhop(jnp.asarray(t2), 5.0,
                                                          jne.RobustLoss[loss.name]))


@pytest.mark.parametrize("weighted", [False, True])
def test_hessian_and_rhs(weighted):
    """Sums of ~600 products of size up to ~1e4 * 1e2: atol 1e-9 * 1e6."""
    rng = np.random.default_rng(5)
    ix, iy, di = (rng.normal(scale=30.0, size=(2, 19, 31, 3)) for _ in range(3))
    w = rng.uniform(0.1, 1.0, (2, 19, 31)) if weighted else None
    s = ttr.param_preconditioner(T.HOMOGRAPHY, 19, 31)
    jx_t, jy_t = ttr.jacobian_fields(T.HOMOGRAPHY, 19, 31, dtype=torch.float64, scale=s)
    jx_j, jy_j = jtr.jacobian_fields(jtr.TransformType.HOMOGRAPHY, 19, 31,
                                     dtype=jnp.float64, scale=s)
    g_t = tne.grad_moments(torch.tensor(ix), torch.tensor(iy))
    g_j = jne.grad_moments(jnp.asarray(ix), jnp.asarray(iy))
    for a, b in zip(g_t, g_j):
        close(a, b, atol=1e-6)
    wt = None if w is None else torch.tensor(w)
    wj = None if w is None else jnp.asarray(w)
    close(tne.hessian(*g_t, jx_t, jy_t, weights=wt, chunk=128),
          jne.hessian(*g_j, jx_j, jy_j, weights=wj, chunk=128), atol=1e-3)
    u_t = tne.residual_moments(torch.tensor(ix), torch.tensor(iy), torch.tensor(di))
    u_j = jne.residual_moments(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(di))
    close(tne.rhs(*u_t, jx_t, jy_t, weights=wt), jne.rhs(*u_j, jx_j, jy_j, weights=wj),
          atol=1e-3)


def spd(b=3, seed=6):
    a = np.random.default_rng(seed).normal(size=(b, 8, 8))
    return a @ a.transpose(0, 2, 1) + 8 * np.eye(8)


def test_cholesky_and_solve():
    h = spd()
    r = np.random.default_rng(7).normal(size=(3, 8))
    close(tne.cholesky_solve8(torch.tensor(h), torch.tensor(r)),
          jne.cholesky_solve8(jnp.asarray(h), jnp.asarray(r)))
    live = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float64)
    s = ttr.param_preconditioner(T.AFFINITY, 20, 30)
    for a, b in zip(tne.solve_normal(torch.tensor(h), torch.tensor(r), live, precond=s),
                    jne.solve_normal(jnp.asarray(h), jnp.asarray(r), live, precond=s)):
        close(a, b)


def test_singular_system_gives_zero_step():
    h = spd()
    h[1] = 0.0                                   # pair 1: all-zero (singular) H
    r = np.random.default_rng(8).normal(size=(3, 8))
    live = np.ones(8)
    dp_t, err_t = tne.solve_normal(torch.tensor(h), torch.tensor(r), live)
    dp_j, err_j = jne.solve_normal(jnp.asarray(h), jnp.asarray(r), live)
    close(dp_t, dp_j)
    close(err_t, err_j)
    assert (dp_t[1] == 0).all() and err_t[1] == 0 and (dp_t[0] != 0).all()


# ---- pyramid ----

def test_zoom_sizes():
    for h, w, n, nu in [(388, 584, 5, 0.5), (140, 180, 4, 0.6), (31, 17, 3, 0.5)]:
        assert tpy.pyramid_shapes(h, w, n, nu) == jpy.pyramid_shapes(h, w, n, nu)
        assert tpy.zoom_size(w, h, nu) == jpy.zoom_size(w, h, nu)


@pytest.mark.parametrize("sigma", [0.6, 2.0])
def test_gaussian_blur(sigma):
    img = images(seed=9)
    close(tpy.gaussian_blur(torch.tensor(img), sigma),
          jpy.gaussian_blur(jnp.asarray(img), sigma))


@pytest.mark.parametrize("method", ["ipol", "antialias"])
def test_zoom_out_and_pyramid(method):
    img = images(1, 40, 52, seed=10)
    close(tpy.zoom_out(torch.tensor(img), 0.5, method), jpy.zoom_out(jnp.asarray(img), 0.5, method))
    for a, b in zip(tpy.build_pyramid(torch.tensor(img), 3, 0.6, method),
                    jpy.build_pyramid(jnp.asarray(img), 3, 0.6, method)):
        close(a, b)


# ---- moment assembly ----

@pytest.mark.parametrize("ttype", MODELS, ids=IDS)
def test_assembly_tensors_equal(ttype):
    jtt = jtr.TransformType[ttype.name]
    ours, theirs = tnq._column_polys(ttype, 53.0), jnq._column_polys(jtt, 53.0)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tnq._assembly(ttype, 37, 53), jnq._assembly(jtt, 37, 53)):
        np.testing.assert_array_equal(a, b)
    m = np.random.default_rng(11).normal(size=(2, 5, 8, 8))
    close(tnq._assemble_h(torch.tensor(m[:, :3]), ttype, 37, 53),
          jnq._assemble_h(jnp.asarray(m[:, :3]), jtt, 37, 53))
    close(tnq._assemble_b(torch.tensor(m[:, 3:]), ttype, 37, 53),
          jnq._assemble_b(jnp.asarray(m[:, 3:]), jtt, 37, 53))


# ---- solver helpers ----

def test_effective_delta_and_lost_overlap():
    for d, h, w in [(10, 388, 584), (10, 25, 37), (10, 5, 5), (3, 64, 96)]:
        assert tic.effective_delta(d, h, w) == jic.effective_delta(d, h, w)
    p = np.zeros((4, 8))
    p[1, 2] = 500.0                                 # shifted far out of the frame
    p[2, 5] = -400.0                                # shifted far above the frame
    p[3, 0] = np.nan
    got = tic._lost_overlap(torch.tensor(p), T.HOMOGRAPHY, 40, 60)
    want = jic._lost_overlap(jnp.asarray(p), jtr.TransformType.HOMOGRAPHY, 40, 60)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [False, True, True, True]


@pytest.mark.parametrize("nanifoutside", [True, False])
def test_masked_residual(nanifoutside):
    rng = np.random.default_rng(12)
    iw, i1 = rng.normal(size=(2, 2, 5, 7, 3))
    valid = rng.uniform(size=(2, 5, 7)) > 0.3
    close(tic._masked_residual(torch.tensor(iw), torch.tensor(valid), torch.tensor(i1),
                               nanifoutside),
          jic._masked_residual(jnp.asarray(iw), jnp.asarray(valid), jnp.asarray(i1),
                               nanifoutside))


@pytest.mark.parametrize("loss", list(R), ids=[l.name for l in R])
def test_fused_system_matches_plain_system(loss):
    """The CUDA solver branch (moments -> assembly) run with the kernels'
    plain versions gives the plain branch's preconditioned H and b. Float32
    sums over ~2000 pixels in two orders: normalized atol 1e-5."""
    rng = np.random.default_rng(13)
    i1, i2 = (torch.tensor(rng.uniform(0, 255, (2, 37, 53, 3)), dtype=torch.float32)
              for _ in range(2))
    ix, iy = tgr.central_gradients(i1)
    band = tgr.boundary_band_mask(37, 53, 4)[None, ..., None]
    ix, iy = ix * band, iy * band
    g = tne.grad_moments(ix, iy)
    p = ttr.pad_params(torch.tensor(homography(), dtype=torch.float32))
    lam = torch.tensor([5.0, 9.0])
    for nan in (True, False):
        scale = ttr.param_preconditioner(T.HOMOGRAPHY, 37, 53)
        fused = tic._fused_system(i1, i2, ix, iy, *g, T.HOMOGRAPHY, loss, nan, 4)(p, lam)
        plain = tic._plain_system(i1, i2, ix, iy, *g, T.HOMOGRAPHY, loss, nan, 4, scale,
                                  16384)(p, lam)
        for a, b in zip(fused, plain):
            n = max(1.0, float(b.abs().max()))
            np.testing.assert_allclose(a.numpy() / n, b.numpy() / n, rtol=0, atol=1e-5)
