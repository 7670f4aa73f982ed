"""The whole slice: the port's align() on the CPU vs the JAX package's align()
(which on the CPU takes the XLA path, the Pallas kernels' own oracle).

Inputs are `synth_pair`-style pairs (tests/conftest.py) at 2x64x96 made
from a seeded smooth image, so the exact ground truth is known. Both sides
run float32 with the same config; the two results must agree to 1e-2 px
of corner displacement (float32 solves whose per-iteration sums run in a
different order), with equal divergence flags and iteration counts
within 1.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as jica
import inverse_compositional_algorithm_tpu_torch as tica
from inverse_compositional_algorithm_tpu.models.ic import ic_solve as j_ic_solve
from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur
from inverse_compositional_algorithm_tpu.ops.transforms import (
    pad_params, transform_grid, transform_points,
)
from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample

torch.set_num_threads(1)

H, W = 64, 96
CORNER_TOL = 1e-2
WARP_ATOL = 2e-3   # 0..255 images, float32 summation order
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synth_batch(ttype_name, ps, seed=0):
    """(I1, I2) numpy float32 [B, H, W, 3]: I2 = smooth image, I1 = I2
    sampled at x'(x; p_gt) per pair, so the solver's fixed point is p_gt."""
    ttype = jica.TransformType[ttype_name]
    rng = np.random.default_rng(seed)
    img = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (1, H, W, 3)), jnp.float32), 2.0)
    p = pad_params(jnp.asarray(ps, jnp.float32))
    gx, gy = transform_grid(p, ttype, H, W)
    i2 = jnp.broadcast_to(img, (len(ps), H, W, 3))
    return np.asarray(bicubic_sample(i2, gx, gy)), np.asarray(i2), np.asarray(p)


def corner_err(pa, pb, ttype_name):
    ttype = jica.TransformType[ttype_name]
    xs = jnp.asarray([0.0, W - 1.0, 0.0, W - 1.0], jnp.float64)
    ys = jnp.asarray([0.0, 0.0, H - 1.0, H - 1.0], jnp.float64)
    ax, ay = transform_points(jnp.asarray(pa, jnp.float64), ttype, xs, ys)
    bx, by = transform_points(jnp.asarray(pb, jnp.float64), ttype, xs, ys)
    return float(jnp.max(jnp.hypot(ax - bx, ay - by)))


CONFIGS = {
    # the flagship's model and loss (annealed lambda), cut to 3 scales
    "flagship": dict(transform="HOMOGRAPHY", robust="CHARBONNIER", nscales=3,
                     p=[[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5],
                        [-0.012, 0.004, -2.0, -0.006, 0.009, 1.25, -4e-5, 2e-5]]),
    # the default AlignConfig's model and loss, cut to 2 scales
    "default": dict(transform="EUCLIDEAN", robust="QUADRATIC", nscales=2,
                    p=[[1.5, -1.0, 0.02], [-2.0, 0.75, -0.015]]),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_align_matches_jax(name):
    c = CONFIGS[name]
    i1, i2, p_gt = synth_batch(c["transform"], c["p"])
    kw = dict(nscales=c["nscales"], delta=10)
    jcfg = jica.AlignConfig(transform=jica.TransformType[c["transform"]],
                            robust=jica.RobustLoss[c["robust"]], **kw)
    want = jica.align(i1, i2, jcfg)
    got = tica.align(i1, i2, tica.config_from_jax(jcfg), device="cpu")
    assert got.p.dtype == torch.float32 and got.p.shape == (2, 8)
    assert corner_err(got.p.numpy(), np.asarray(want.p), c["transform"]) <= CORNER_TOL
    assert corner_err(got.p.numpy(), p_gt, c["transform"]) <= CORNER_TOL
    np.testing.assert_array_equal(got.diverged.numpy(), np.asarray(want.diverged))
    assert np.abs(got.niters.numpy() - np.asarray(want.niters)).max() <= 1
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    fin = got.valid.numpy()
    np.testing.assert_allclose(got.iw.numpy()[fin], np.asarray(want.iw)[fin], atol=0.05)
    assert np.isnan(got.iw.numpy()[~fin]).all()


def test_ic_solve_trace_matches_jax_float64():
    """One robust scale with collect_trace, float64 on both sides: the p,
    error and annealed-lambda histories agree (atol 1e-8: float64 solves
    iterated over up to 10 steps)."""
    i1, i2, _ = synth_batch("SIMILARITY", [[1.0, -0.5, 0.01, 0.005], [0.5, 0.25, 0.0, 0.01]])
    kw = dict(robust=jica.RobustLoss.LORENTZIAN, delta=5, max_iter=10, collect_trace=True)
    p0 = np.zeros((2, 8))
    js, (je, jp, jl) = j_ic_solve(jnp.asarray(i1, jnp.float64), jnp.asarray(i2, jnp.float64),
                                  jnp.asarray(p0), jica.TransformType.SIMILARITY, **kw)
    kw["robust"] = tica.RobustLoss.LORENTZIAN
    ts, (te, tp, tl) = tica.ic_solve(torch.tensor(i1, dtype=torch.float64),
                                     torch.tensor(i2, dtype=torch.float64),
                                     torch.tensor(p0), tica.TransformType.SIMILARITY, **kw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-8)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.niters.numpy(), np.asarray(js.niters))


def test_divergence_guard_matches_jax():
    """A warm start far outside the frame trips the guard on both sides:
    p reverts to p0, the pair is flagged and stops."""
    i1, i2, _ = synth_batch("TRANSLATION", [[1.0, -1.0], [0.5, 0.5]])
    p0 = np.zeros((2, 8), np.float32)
    p0[1, :2] = [200.0, -150.0]
    kw = dict(delta=5, max_iter=10)
    js = j_ic_solve(jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(p0),
                    jica.TransformType.TRANSLATION, **kw)
    ts = tica.ic_solve(torch.tensor(i1), torch.tensor(i2), torch.tensor(p0),
                       tica.TransformType.TRANSLATION, **kw)
    np.testing.assert_array_equal(ts.diverged.numpy(), np.asarray(js.diverged))
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), atol=1e-4)
    np.testing.assert_array_equal(ts.niters.numpy(), np.asarray(js.niters))


def test_transform_image_and_warp_match_jax():
    i1, i2, _ = synth_batch("AFFINITY", [[1.0, -1.0, 0.02, -0.01, 0.015, -0.02]])
    gt = np.array([1.0, -0.5, 0.01, 0.0, 0.0, 0.02], np.float32)
    got = tica.transform_image(torch.tensor(i2[0]), tica.TransformType.AFFINITY,
                               torch.tensor(gt))
    want = jica.transform_image(jnp.asarray(i2[0]), jica.TransformType.AFFINITY,
                                jnp.asarray(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=WARP_ATOL)
    cfg = jica.AlignConfig(transform=jica.TransformType.AFFINITY, delta=3)
    got = tica.warp(torch.tensor(i2), torch.tensor(gt), tica.config_from_jax(cfg))
    want = np.asarray(jica.warp(jnp.asarray(i2), jnp.asarray(gt), cfg))
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_ATOL, equal_nan=True)


def test_numpy_input_needs_a_device(monkeypatch):
    """Numpy input goes to CUDA by default: with no card, align, warp and
    transform_image raise (they never fall back to the CPU), and
    device="cpu" runs the plain path. A tensor on one device with device=
    naming another raises ValueError. The CUDA side is in test_torch_gpu.py."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    i1, i2, _ = synth_batch("TRANSLATION", [[1.0, -1.0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tica.align(i1, i2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tica.warp(i2[0], np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tica.transform_image(i2[0], tica.TransformType.TRANSLATION, np.zeros(2, np.float32))
    assert tica.warp(i2[0], np.zeros(3, np.float32), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        tica.align(torch.tensor(i1), torch.tensor(i2), device="meta")


def test_port_never_imports_jax():
    """Importing the port with its entry points (parallel/ and the
    stabilization walkthrough included) and running a small align leaves
    jax and the JAX package unimported."""
    code = (
        "import sys, numpy as np\n"
        "import inverse_compositional_algorithm_tpu_torch as ica\n"
        "from inverse_compositional_algorithm_tpu_torch import cli\n"
        "from inverse_compositional_algorithm_tpu_torch.eval import (\n"
        "    attr_bench, benchmarks, harness, plots, profile_stages, run_eval)\n"
        "from inverse_compositional_algorithm_tpu_torch.models import layers\n"
        "from inverse_compositional_algorithm_tpu_torch.ops import matrix_operators\n"
        "from inverse_compositional_algorithm_tpu_torch.ops.kernels import warp_floor\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('s', 'examples/stabilize_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from inverse_compositional_algorithm_tpu_torch.parallel import (\n"
        "    launch, mesh, ranks, scaling, sharded, spawn, tiled)\n"
        "from inverse_compositional_algorithm_tpu_torch.utils import (\n"
        "    imageio, profiling, validation)\n"
        "img = np.random.default_rng(0).uniform(0, 255, (24, 32, 3))\n"
        "r = ica.align(img, img, ica.AlignConfig(nscales=1, delta=2), device='cpu')\n"
        "assert r.p.shape == (8,), r.p.shape\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('inverse_compositional_algorithm_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
