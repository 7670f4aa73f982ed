"""The port's CUDA kernels (K1 fused iteration, K3 warp, K4 moments, K5 warp
floor) against their plain PyTorch versions (K1 and K3 also on the row
shards of the row-tiled solver), and its entry points (align, the
benchmark, the eval harness, the row-tiled solver on two gloo ranks that
share the card), on a CUDA device.

Every test needs a CUDA device and nvcc, and skips without them. The file
imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: moments normalized by max(|ref|, 1) at atol 2e-4, warps of
0..255 images at atol 2e-3 (float32 sums taken in another order), NaN
positions equal; reruns bitwise equal (no atomics on any result).
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


def bitwise_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def grid(ttype, p, b, h, w, dev):
    pp = ica.pad_params(torch.tensor(p, dtype=torch.float32, device=dev)).expand(b, 8)
    return ica.transform_grid(pp, ttype, h, w)


def motion(ttype, p, b, dev):
    """(K1's [b, 3, 3] motion matrices of p, projective)."""
    pp = ica.pad_params(torch.tensor(p, dtype=torch.float32, device=dev)).expand(b, 8)
    return ica.params_to_matrix(pp, ttype).contiguous(), ttype is T.HOMOGRAPHY


MOTIONS = {
    "homography": (T.HOMOGRAPHY, [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5]),
    "euclidean": (T.EUCLIDEAN, [1.5, -0.5, 0.05]),
    "rotation69": (T.EUCLIDEAN, [0.0, 0.0, 1.2]),
    "diverged": (T.HOMOGRAPHY, [-1.2, -2.5, 33.0, 0.04, -3.3, 26.0, 1.5e-3, -0.1]),
}


@pytest.mark.parametrize("name", ["homography", "rotation69", "diverged"])
def test_warp_planar(cuda, name):
    img = rand((2, 3, 64, 200), 0, cuda)
    gx, gy = grid(*MOTIONS[name], 2, 64, 200, cuda)
    got, ref = k3.warp_planar(img, gx, gy), k3.warp_planar_ref(img, gx, gy)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    assert float((got[fin] - ref[fin]).abs().max()) <= WARP_TOL
    assert bitwise_equal(got, k3.warp_planar(img, gx, gy))


@pytest.mark.parametrize("name,b,c,h,w", [
    ("euclidean", 2, 3, 49, 73), ("homography", 2, 1, 25, 37), ("rotation69", 2, 2, 64, 200),
    ("homography", 1, 3, 388, 584), ("homography", 16, 3, 388, 584),
], ids=["ragged49x73", "gray25x37", "twochannel_rotation69", "batch1", "batch16"])
def test_warp_planar_shapes(cuda, name, b, c, h, w):
    """K3 where the bands' edges, the channel count (RGB unrolled, any other
    C in a loop) and the batch matter: NaN positions equal, reruns bitwise
    equal."""
    img = rand((b, c, h, w), 0, cuda)
    gx, gy = grid(*MOTIONS[name], b, h, w, cuda)
    got, ref = k3.warp_planar(img, gx, gy), k3.warp_planar_ref(img, gx, gy)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    assert float((got[fin] - ref[fin]).abs().max()) <= WARP_TOL
    assert bitwise_equal(got, k3.warp_planar(img, gx, gy))


@pytest.mark.parametrize("k,h,w", [(3, 21, 37), (5, 97, 146), (1, 25, 37)])
def test_weighted_moments(cuda, k, h, w):
    maps = rand((2, k, h, w), 1, cuda, scale=1.0) - 0.5
    got = k4.weighted_moments(maps)
    normalized_close(got, k4.weighted_moments_ref(maps))
    assert bool((got[:, :, 5:, :] == 0).all() and (got[:, :, :, 5:] == 0).all())
    assert torch.equal(got, k4.weighted_moments(maps))       # no atomics: bit-identical


def k1_plan(b, h, w, delta, dev):
    i1 = rand((b, h, w, 3), 2, dev)
    i2 = rand((b, h, w, 3), 3, dev)
    ix, iy = gradients.central_gradients(i1)
    band = gradients.boundary_band_mask(h, w, delta, device=dev)[None, :, :, None]
    ix, iy = ix * band, iy * band
    return k1.plan_fused_iter(i1, i2, ix, iy, *normal_equations.grad_moments(ix, iy))


@pytest.mark.parametrize("robust,nan", [(R.CHARBONNIER, True), (R.TRUNCATED_QUADRATIC, True),
                                        (R.GERMAN_MCCLURE, True), (R.LORENTZIAN, True),
                                        (None, True), (R.CHARBONNIER, False)])
def test_fused_iter(cuda, robust, nan):
    b, h, w, delta = 2, 49, 73, 4
    plan = k1_plan(b, h, w, delta, cuda)
    lam = torch.tensor([5.0, 17.0], device=cuda)
    args = (plan.i2p, plan.tplp, *motion(*MOTIONS["euclidean"], b, cuda), lam, h, w, robust,
            nan, delta)
    got = k1.fused_iter_moments(*args, y_offset=3)
    normalized_close(got, k1.fused_iter_moments_ref(*args, y_offset=3))
    assert torch.equal(got, k1.fused_iter_moments(*args, y_offset=3))


@pytest.mark.parametrize("name,b,h,w", [
    ("rotation69", 2, 64, 200), ("diverged", 2, 64, 200), ("euclidean", 2, 49, 73),
    ("homography", 2, 25, 37), ("homography", 1, 388, 584), ("homography", 16, 388, 584),
], ids=["rotation69", "diverged", "ragged49x73", "coarsest25x37", "batch1", "batch16"])
def test_fused_iter_motions_and_shapes(cuda, name, b, h, w):
    """K1 against its plain version where the motion's extremes and the
    bands' edges matter: NaN positions equal where the moments go
    non-finite (the diverged homography), reruns bitwise equal."""
    delta = min(10, (min(h, w) - 1) // 4)
    plan = k1_plan(b, h, w, delta, cuda)
    lam = torch.linspace(5.0, 80.0, b, device=cuda)
    args = (plan.i2p, plan.tplp, *motion(*MOTIONS[name], b, cuda), lam, h, w, R.CHARBONNIER,
            True, delta)
    got, ref = k1.fused_iter_moments(*args), k1.fused_iter_moments_ref(*args)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    assert bool(fin.all()) == (name != "diverged")
    normalized_close(got[fin], ref[fin])
    assert bitwise_equal(got, k1.fused_iter_moments(*args))


@pytest.mark.parametrize("nt", [2, 4])
def test_fused_iter_row_shards(cuda, nt):
    """K1 on row shards (Ho = H/nt, y_offset = the shard's first row), as
    the row-tiled solver runs it: each shard against its plain version, and
    the shards' moments sum to the whole frame's."""
    b, h, w, delta = 2, 48, 72, 5
    plan = k1_plan(b, h, w, delta, cuda)
    lam = torch.tensor([5.0, 17.0], device=cuda)
    mat, projective = motion(*MOTIONS["homography"], b, cuda)
    rows = h // nt
    total = 0
    for r in range(nt):
        tplp = plan.tplp[:, :, r * rows:(r + 1) * rows].contiguous()
        args = (plan.i2p, tplp, mat, projective, lam, h, w, R.CHARBONNIER, True, delta)
        got = k1.fused_iter_moments(*args, y_offset=r * rows)
        normalized_close(got, k1.fused_iter_moments_ref(*args, y_offset=r * rows))
        assert bitwise_equal(got, k1.fused_iter_moments(*args, y_offset=r * rows))
        total = total + got
    whole = k1.fused_iter_moments(plan.i2p, plan.tplp, mat, projective, lam, h, w,
                                  R.CHARBONNIER, True, delta)
    normalized_close(total, whole)


def test_warp_planar_local_rows(cuda):
    """K3 on one rank's rows (coordinates with the global y_offset, the
    whole frame as source) gives the whole-frame warp's rows, bit for bit."""
    b, h, w, rows = 2, 64, 200, 16
    img = rand((b, 3, h, w), 0, cuda)
    ttype, p = MOTIONS["homography"]
    pp = ica.pad_params(torch.tensor(p, device=cuda)).expand(b, 8)
    whole = k3.warp_planar(img, *ica.transform_grid(pp, ttype, h, w))
    for y0 in range(0, h, rows):
        got = k3.warp_planar(img, *ica.transform_grid(pp, ttype, rows, w, y_offset=y0))
        assert bitwise_equal(got, whole[:, :, y0:y0 + rows])


def test_tiled_ic_solve_two_gloo_ranks_on_one_card(cuda):
    """tiled_ic_solve as 2 gloo ranks sharing the card (K1 on row shards,
    the moments all-reduced) against single-card ic_solve: within 1e-2 px
    of corner displacement (float32 sums in another order), equal flags,
    and every rank launched K1."""
    from inverse_compositional_algorithm_tpu_torch.parallel.ranks import drive
    from inverse_compositional_algorithm_tpu_torch.parallel.spawn import run_ranks

    base = ica.ops.pyramid.gaussian_blur(rand((1, 96, 128, 3), 7, "cpu"), 2.0)
    ttype = T.HOMOGRAPHY
    pp = ica.pad_params(torch.tensor([[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5]]))
    i1 = ica.ops.warp.bicubic_sample(base, *ica.transform_grid(pp, ttype, 96, 128))
    i1, i2 = torch.cat([i1, base]), torch.cat([base, base])
    kw = dict(ttype=ttype, delta=8, robust=R.CHARBONNIER)
    cases = {"s": {"entry": "tiled_ic_solve", "mesh": (1, 2), "kwargs": kw}}
    outs = run_ranks(drive, 2, device="cuda", backend="gloo", timeout_s=240,
                     args={"s.i1": i1.numpy(), "s.i2": i2.numpy()}, kwargs={"cases": cases})
    kw.pop("ttype")
    want = ica.ic_solve(i1.to(cuda), i2.to(cuda), torch.zeros((2, 8), device=cuda), ttype, **kw)
    xs, ys = [0.0, 127.0, 0.0, 127.0], [0.0, 0.0, 95.0, 95.0]
    bx, by = ica.ops.transforms.transform_points(want.p.cpu().double(), ttype, xs, ys)
    for o in outs:
        assert o["launches"]["fused_iter_moments"] > 0
        got = torch.tensor(o["out"]["s.p"]).double()
        ax, ay = ica.ops.transforms.transform_points(got, ttype, xs, ys)
        assert float(torch.hypot(ax - bx, ay - by).max()) <= 1e-2
        np.testing.assert_array_equal(o["out"]["s.diverged"], want.diverged.cpu().numpy())
        np.testing.assert_array_equal(o["out"]["s.p"], outs[0]["out"]["s.p"])


def test_launch_runs_on_the_operands_device(cuda):
    """Tensors on cuda:1 while cuda:0 is the current device: K1 and K3
    launch on cuda:1 and give cuda:0's results."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    b, h, w, delta = 2, 49, 73, 4
    plan = k1_plan(b, h, w, delta, cuda)
    lam = torch.tensor([5.0, 17.0], device=cuda)
    mat, projective = motion(*MOTIONS["euclidean"], b, cuda)
    gx, gy = grid(*MOTIONS["euclidean"], b, h, w, cuda)
    args = (plan.i2p, plan.tplp, mat, projective, lam, h, w, R.CHARBONNIER, True, delta)
    want = (k1.fused_iter_moments(*args), k3.warp_planar(plan.i2p, gx, gy))
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        got = (k1.fused_iter_moments(*(a.to(other) if isinstance(a, torch.Tensor) else a
                                       for a in args)),
               k3.warp_planar(plan.i2p.to(other), gx.to(other), gy.to(other)))
        torch.cuda.synchronize(other)
    for g, wnt in zip(got, want):
        assert g.device == other
        assert bitwise_equal(g.cpu(), wnt.cpu())


def test_launch_raises_on_operands_of_two_cards(cuda):
    """Operands spread over cuda:0 and cuda:1 raise before any launch: a
    kernel never runs on one card with another card's pointers."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    b, h, w = 2, 49, 73
    img = rand((b, 3, h, w), 0, cuda)
    gx, gy = grid(*MOTIONS["euclidean"], b, h, w, cuda)
    other = torch.device("cuda", 1)
    before = k3.LAUNCHES
    with pytest.raises(ValueError, match="one device"):
        k3.warp_planar(img, gx.to(other), gy.to(other))
    plan = k1_plan(b, h, w, 4, cuda)
    mat, projective = motion(*MOTIONS["euclidean"], b, cuda)
    lam = torch.tensor([5.0, 17.0], device=cuda)
    launched = k1.LAUNCHES
    with pytest.raises(ValueError, match="one device"):
        k1.fused_iter_moments(plan.i2p, plan.tplp, mat.to(other), projective, lam, h, w,
                              R.CHARBONNIER, True, 4)
    assert (k3.LAUNCHES, k1.LAUNCHES) == (before, launched)


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


@pytest.mark.parametrize("shape", [(2, 3, 37, 70), (1, 1, 4, 4), (8, 3, 388, 584),
                                   (1, 3, 45, 135), (16, 3, 388, 584), (1, 3, 2160, 3840)])
def test_warp_floor(cuda, shape):
    """K5 on both load paths (TMA where W % 4 == 0, plain loads at W = 70
    and 135), ragged tiles and the masked edge: reruns bitwise equal."""
    img = rand(shape, 8, cuda)
    before = k5.LAUNCHES
    got = k5.warp_floor(img)
    assert k5.LAUNCHES == before + 1
    assert got.shape == (shape[0], shape[1], shape[2] - 3, shape[3] - 3)
    assert float((got - k5.warp_floor_ref(img)).abs().max()) <= WARP_TOL
    assert bitwise_equal(got, k5.warp_floor(img))


def test_warp_floor_misaligned_base(cuda):
    """A frame TMA could take but for its base 4 bytes past a 16-byte
    boundary runs the plain-load path, and agrees."""
    n = 2 * 3 * 45 * 136
    buf = rand((4 + n,), 9, cuda)
    img = buf[1:1 + n].view(2, 3, 45, 136)
    assert not k5.uses_tma(img) and k5.uses_tma(buf[4:].view(2, 3, 45, 136))
    got = k5.warp_floor(img)
    assert float((got - k5.warp_floor_ref(img)).abs().max()) <= WARP_TOL
    assert bitwise_equal(got, k5.warp_floor(img))


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
