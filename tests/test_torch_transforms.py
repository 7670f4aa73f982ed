"""PyTorch port vs the JAX package: constants, config and geometry.

Float64 on both sides (conftest enables JAX x64), inputs made with numpy
from a seed. Tolerance: atol 1e-9 — the two sides evaluate the same
formulas in float64, so they may differ only by summation order.
"""

import configparser
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as jica
import inverse_compositional_algorithm_tpu_torch as tica
from inverse_compositional_algorithm_tpu import config as jconfig
from inverse_compositional_algorithm_tpu import constants as jcts
from inverse_compositional_algorithm_tpu.ops import transforms as jtr
from inverse_compositional_algorithm_tpu_torch import config as tconfig
from inverse_compositional_algorithm_tpu_torch import constants as tcts
from inverse_compositional_algorithm_tpu_torch.ops import transforms as ttr

torch.set_num_threads(1)

ATOL = 1e-9
T = tica.TransformType

PARAMS = {
    T.TRANSLATION: [3.25, -2.5],
    T.EUCLIDEAN: [1.5, -0.5, 0.05],
    T.SIMILARITY: [0.5, 1.0, 0.04, -0.06],
    T.AFFINITY: [1.0, -1.0, 0.05, -0.02, 0.08, -0.04],
    T.HOMOGRAPHY: [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5],
}
MODELS = list(T)
IDS = [t.name for t in T]


def jt(ttype):
    return jtr.TransformType[ttype.name]


def batch_params(ttype, b=3, seed=0):
    """[b, 8] float64: the model's case plus small seeded perturbations."""
    rng = np.random.default_rng(seed)
    p = np.zeros((b, 8))
    base = np.asarray(PARAMS[ttype])
    p[:, : base.size] = base * (1.0 + 0.3 * rng.standard_normal((b, base.size)))
    return p


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def test_enums_match():
    for ours, theirs in [(tica.TransformType, jica.TransformType),
                         (tica.RobustLoss, jica.RobustLoss)]:
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    for t in T:
        assert tica.nparams(t) == jica.nparams(jt(t)) == t.n


def test_constants_match():
    for name in ("MAX_ITER", "LAMBDA_0", "LAMBDA_N", "LAMBDA_RATIO",
                 "ZOOM_SIGMA_ZERO", "NPARAMS_MAX"):
        assert getattr(tcts, name) == getattr(jcts, name)


def test_config_fields_match():
    theirs = {f.name: f.default for f in dataclasses.fields(jconfig.AlignConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(tconfig.AlignConfig)}
    assert set(theirs) - set(ours) == {"use_pallas", "interpret"}
    assert set(ours) <= set(theirs)
    for name, default in ours.items():
        want = theirs[name]
        if hasattr(want, "name"):
            assert default.name == want.name
        else:
            assert default == want


def test_config_from_jax():
    src = jica.AlignConfig(transform=jica.TransformType.HOMOGRAPHY,
                           robust=jica.RobustLoss.LORENTZIAN, lam=3.0, tol=2e-4,
                           nscales=4, nu=0.6, nanifoutside=False, delta=7,
                           pyramid_method="antialias", use_pallas=False)
    got = tica.config_from_jax(src)
    assert got == tica.AlignConfig(transform=T.HOMOGRAPHY,
                                   robust=tica.RobustLoss.LORENTZIAN, lam=3.0,
                                   tol=2e-4, nscales=4, nu=0.6, nanifoutside=False,
                                   delta=7, pyramid_method="antialias")
    assert tica.config_from_jax(jica.AlignConfig()) == tica.AlignConfig()


@pytest.mark.parametrize("robust", ["QUADRATIC", "CHARBONNIER"])
def test_ini_written_identically(tmp_path, robust):
    kw = dict(lam=2.5, tol=5e-4, nscales=3, nu=0.7)
    jpath, tpath = tmp_path / "j.ini", tmp_path / "t.ini"
    jconfig.write_config_file(str(jpath), jica.AlignConfig(
        transform=jica.TransformType.AFFINITY, robust=jica.RobustLoss[robust], **kw))
    tica.write_config_file(str(tpath), tica.AlignConfig(
        transform=T.AFFINITY, robust=tica.RobustLoss[robust], **kw))
    a, b = configparser.ConfigParser(), configparser.ConfigParser()
    a.read(jpath)
    b.read(tpath)
    assert {s: dict(a[s]) for s in a.sections()} == {s: dict(b[s]) for s in b.sections()}


# The reference's config.ini layout (three sections, inline comments).
REFERENCE_INI = """\
[InverseCompositionalAlgorithm]
tol = 0.001 # convergence threshold
transform_type = EUCLIDEAN
verbose = False

[RobustInverseCompositionalAlgorithm]
tol = 0.001
transform_type = EUCLIDEAN
robust_type = CHARBONNIER ; IRLS loss
lambda = 0.0
verbose = False

[PyramidalInverseCompositionalAlgorithm]
tol = 0.001
transform_type = EUCLIDEAN
pyramid_levels = 5
nu = 0.5
robust_type = QUADRATIC
lambda = 0.0
verbose = False
"""


def test_reads_reference_format(tmp_path):
    path = tmp_path / "config.ini"
    path.write_text(REFERENCE_INI)
    ours = tica.read_config_file(str(path))
    theirs = jica.read_config_file(str(path))
    assert set(ours) == set(theirs)
    for key, cfg in theirs.items():
        assert ours[key] == tica.config_from_jax(cfg)
    pyr = ours["pyramidal_inverse_compositional_algorithm"]
    assert pyr.nscales == 5 and pyr.robust is tica.RobustLoss.QUADRATIC


@pytest.mark.parametrize("ttype", MODELS, ids=IDS)
def test_matrix_roundtrip(ttype):
    p = batch_params(ttype)
    m_t = ttr.params_to_matrix(torch.tensor(p), ttype)
    m_j = jtr.params_to_matrix(jnp.asarray(p), jt(ttype))
    close(m_t, m_j)
    close(ttr.matrix_to_params(m_t, ttype), jtr.matrix_to_params(m_j, jt(ttype)))
    k = ttype.n
    close(ttr.pad_params(torch.tensor(p[:, :k]), ttype),
          jtr.pad_params(jnp.asarray(p[:, :k]), jt(ttype)))


@pytest.mark.parametrize("ttype", MODELS, ids=IDS)
def test_compose_and_invert(ttype):
    p = batch_params(ttype, seed=1)
    dp = 0.1 * batch_params(ttype, seed=2)
    close(ttr.compose_inverse(torch.tensor(p), torch.tensor(dp), ttype),
          jtr.compose_inverse(jnp.asarray(p), jnp.asarray(dp), jt(ttype)))
    close(ttr.invert_params(torch.tensor(p), ttype),
          jtr.invert_params(jnp.asarray(p), jt(ttype)))


def test_compose_degenerate_guard():
    """A singular update (det of M(dp)'s linear part = 0) leaves p unchanged."""
    p = batch_params(T.AFFINITY, b=1)
    dp = np.zeros((1, 8))
    dp[0, 2] = -1.0                      # 1 + a00 = 0 -> det2 = 0
    got = ttr.compose_inverse(torch.tensor(p), torch.tensor(dp), T.AFFINITY)
    want = jtr.compose_inverse(jnp.asarray(p), jnp.asarray(dp), jtr.TransformType.AFFINITY)
    close(got, want)
    close(got, p)


@pytest.mark.parametrize("ttype", MODELS, ids=IDS)
def test_transform_grid_and_points(ttype):
    p = batch_params(ttype, seed=3)
    gx_t, gy_t = ttr.transform_grid(torch.tensor(p), ttype, 9, 13, y_offset=4)
    gx_j, gy_j = jtr.transform_grid(jnp.asarray(p), jt(ttype), 9, 13, y_offset=4)
    close(gx_t, gx_j)
    close(gy_t, gy_j)
    xs, ys = [0.0, 12.0, 3.5], [0.0, 8.0, -2.0]
    px_t, py_t = ttr.transform_points(torch.tensor(p), ttype, xs, ys)
    px_j, py_j = jtr.transform_points(jnp.asarray(p), jt(ttype), jnp.asarray(xs), jnp.asarray(ys))
    close(px_t, px_j)
    close(py_t, py_j)


@pytest.mark.parametrize("ttype", MODELS, ids=IDS)
def test_jacobian_and_preconditioner(ttype):
    s_t = ttr.param_preconditioner(ttype, 9, 13)
    s_j = jtr.param_preconditioner(jt(ttype), 9, 13)
    np.testing.assert_array_equal(s_t, s_j)
    jx_t, jy_t = ttr.jacobian_fields(ttype, 9, 13, dtype=torch.float64, scale=s_t, y_offset=2)
    jx_j, jy_j = jtr.jacobian_fields(jt(ttype), 9, 13, dtype=jnp.float64, scale=s_j,
                                     y_offset=2)
    close(jx_t, jx_j)
    close(jy_t, jy_j)


@pytest.mark.parametrize("ttype", MODELS, ids=IDS)
def test_zoom_in_params(ttype):
    p = batch_params(ttype, seed=4)
    close(ttr.zoom_in_params(torch.tensor(p), ttype, 37, 25, 73, 49),
          jtr.zoom_in_params(jnp.asarray(p), jt(ttype), 37, 25, 73, 49))
