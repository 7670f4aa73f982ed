"""The port's CUDA kernels (K1 fused iteration, K3 warp, K4 moments, K5 warp
floor) against their plain PyTorch versions, and its entry points (align,
the benchmark, the eval harness), on a CUDA device.

Every test needs a CUDA device and nvcc, and skips without them. The file
imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: moments normalized by max(|ref|, 1) at atol 2e-4, warps of
0..255 images at atol 2e-3 (float32 sums taken in another order), NaN
positions equal.
"""

import numpy as np
import pytest
import torch

import inverse_compositional_algorithm_tpu_torch as ica
from inverse_compositional_algorithm_tpu_torch.ops import gradients, normal_equations
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as k1
from inverse_compositional_algorithm_tpu_torch.ops.kernels import normal_eq as k4
from inverse_compositional_algorithm_tpu_torch.ops.kernels import warp as k3
from inverse_compositional_algorithm_tpu_torch.ops.kernels import warp_floor as k5

torch.set_num_threads(1)

T = ica.TransformType
R = ica.RobustLoss
MOM_TOL = 2e-4
WARP_TOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand(shape, seed, dev, scale=255.0):
    return torch.tensor(np.random.default_rng(seed).uniform(0, scale, shape),
                        dtype=torch.float32, device=dev)


def normalized_close(got, ref):
    n = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) / n <= MOM_TOL


def grid(ttype, p, b, h, w, dev):
    pp = ica.pad_params(torch.tensor(p, dtype=torch.float32, device=dev)).expand(b, 8)
    return ica.transform_grid(pp, ttype, h, w)


@pytest.mark.parametrize("ttype,p", [
    (T.HOMOGRAPHY, [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5]),
    (T.EUCLIDEAN, [0.0, 0.0, 1.2]),
    (T.HOMOGRAPHY, [-1.2, -2.5, 33.0, 0.04, -3.3, 26.0, 1.5e-3, -0.1]),
], ids=["homography", "rotation69", "diverged"])
def test_warp_planar(cuda, ttype, p):
    img = rand((2, 3, 64, 200), 0, cuda)
    gx, gy = grid(ttype, p, 2, 64, 200, cuda)
    got, ref = k3.warp_planar(img, gx, gy), k3.warp_planar_ref(img, gx, gy)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    assert float((got[fin] - ref[fin]).abs().max()) <= WARP_TOL


@pytest.mark.parametrize("k,h,w", [(3, 21, 37), (5, 97, 146), (1, 25, 37)])
def test_weighted_moments(cuda, k, h, w):
    maps = rand((2, k, h, w), 1, cuda, scale=1.0) - 0.5
    got = k4.weighted_moments(maps)
    normalized_close(got, k4.weighted_moments_ref(maps))
    assert bool((got[:, :, 5:, :] == 0).all() and (got[:, :, :, 5:] == 0).all())
    assert torch.equal(got, k4.weighted_moments(maps))       # no atomics: bit-identical


@pytest.mark.parametrize("robust,nan", [(R.CHARBONNIER, True), (R.TRUNCATED_QUADRATIC, True),
                                        (R.GERMAN_MCCLURE, True), (R.LORENTZIAN, True),
                                        (None, True), (R.CHARBONNIER, False)])
def test_fused_iter(cuda, robust, nan):
    b, h, w, delta = 2, 49, 73, 4
    i1 = rand((b, h, w, 3), 2, cuda)
    i2 = rand((b, h, w, 3), 3, cuda)
    ix, iy = gradients.central_gradients(i1)
    band = gradients.boundary_band_mask(h, w, delta, device=cuda)[None, :, :, None]
    ix, iy = ix * band, iy * band
    plan = k1.plan_fused_iter(i1, i2, ix, iy, *normal_equations.grad_moments(ix, iy))
    gx, gy = grid(T.EUCLIDEAN, [1.5, -0.5, 0.05], b, h, w, cuda)
    lam = torch.tensor([5.0, 17.0], device=cuda)
    args = (plan.i2p, plan.tplp, gx, gy, lam, h, w, robust, nan, delta)
    got = k1.fused_iter_moments(*args, y_offset=3)
    normalized_close(got, k1.fused_iter_moments_ref(*args, y_offset=3))
    assert torch.equal(got, k1.fused_iter_moments(*args, y_offset=3))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    img = rand((1, 3, 16, 24), 4, cuda)
    gx, gy = grid(T.TRANSLATION, [1.0, 1.0], 1, 16, 24, cuda)
    with pytest.raises(TypeError):
        k3.warp_planar(img.double(), gx, gy)
    with pytest.raises(ValueError):
        k3.warp_planar(img.transpose(2, 3).contiguous().transpose(2, 3), gx, gy)
    with pytest.raises(ValueError):
        k3.warp_planar(img, gx.cpu(), gy)
    with pytest.raises(ValueError):
        k4.weighted_moments(rand((1, 6, 16, 24), 7, cuda))
    with pytest.raises(ValueError):
        ica.align(rand((16, 24, 3), 5, cuda).double(), rand((16, 24, 3), 6, cuda).double(),
                  dtype=torch.float64)


def test_align_on_cuda_matches_cpu(cuda):
    """align() on CUDA goes through K1 and K3 (and K4 for QUADRATIC) and
    lands within 1e-2 px of corner displacement of the CPU plain path."""
    base = torch.tensor(np.random.default_rng(7).uniform(0, 255, (1, 97, 146, 3)),
                        dtype=torch.float32)
    base = ica.ops.pyramid.gaussian_blur(base, 2.0)
    p = torch.tensor([[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5]])
    gx, gy = ica.transform_grid(p, T.HOMOGRAPHY, 97, 146)
    i1 = ica.ops.warp.bicubic_sample(base, gx, gy)
    for cfg in [ica.AlignConfig(transform=T.HOMOGRAPHY, robust=R.CHARBONNIER, nscales=3),
                ica.AlignConfig(nscales=3)]:
        for m in (k1, k3, k4):
            m.LAUNCHES = 0
        gpu = ica.align(i1.to(cuda), base.to(cuda), cfg)
        assert k1.LAUNCHES > 0 and k3.LAUNCHES == 1
        assert (k4.LAUNCHES > 0) == (cfg.robust is R.QUADRATIC)
        cpu = ica.align(i1, base, cfg)
        xs, ys = [0.0, 145.0, 0.0, 145.0], [0.0, 0.0, 96.0, 96.0]
        ax, ay = ica.ops.transforms.transform_points(gpu.p.cpu().double(), cfg.transform, xs, ys)
        bx, by = ica.ops.transforms.transform_points(cpu.p.double(), cfg.transform, xs, ys)
        assert float(torch.hypot(ax - bx, ay - by).max()) <= 1e-2
        assert torch.equal(gpu.diverged.cpu(), cpu.diverged)


@pytest.mark.parametrize("shape", [(2, 3, 37, 70), (1, 1, 4, 4), (8, 3, 388, 584)])
def test_warp_floor(cuda, shape):
    img = rand(shape, 8, cuda)
    before = k5.LAUNCHES
    got = k5.warp_floor(img)
    assert k5.LAUNCHES == before + 1
    assert got.shape == (shape[0], shape[1], shape[2] - 3, shape[3] - 3)
    assert float((got - k5.warp_floor_ref(img)).abs().max()) <= WARP_TOL


def test_numpy_input_runs_on_cuda_by_default(cuda):
    img = np.random.default_rng(9).uniform(0, 255, (24, 32, 3))
    res = ica.align(img, img, ica.AlignConfig(nscales=1, delta=2))
    assert res.p.is_cuda and res.iw.is_cuda
    assert ica.warp(img, np.zeros(3, np.float32)).is_cuda
    assert ica.transform_image(img, T.TRANSLATION, np.zeros(2, np.float32)).is_cuda


def test_run_benchmark_record(cuda):
    from inverse_compositional_algorithm_tpu_torch.eval import benchmarks

    rec = benchmarks.run_benchmark(full=False, repeats=2)
    for key in ("metric", "value", "unit", "vs_baseline", "batch", "seconds_per_batch",
                "mean_finest_iters", "samples", "device", "card", "timing"):
        assert key in rec
    assert rec["card"]["name"] == torch.cuda.get_device_name(0)
    assert rec["value"] > 0 and rec["samples"]["n"] == 3
    assert all(v > 0 for v in rec["samples"].values())


def test_evaluate_on_cuda_matches_cpu(cuda):
    from inverse_compositional_algorithm_tpu_torch.eval import harness, run_eval

    images = np.stack(run_eval._procedural_textures(4, 96, seed=1))
    cfg = ica.AlignConfig(transform=T.AFFINITY, robust=R.CHARBONNIER, nscales=2, delta=6)
    got = harness.evaluate(images, cfg)
    want = harness.evaluate(images, cfg, device="cpu")
    assert got.converged_frac == want.converged_frac == 1.0
    assert got.diverged_frac == want.diverged_frac
    assert abs(got.mae - want.mae) <= 1e-4 and abs(got.max_err - want.max_err) <= 1e-3
