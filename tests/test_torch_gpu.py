"""The port's CUDA kernels (K1 fused iteration, K3 warp, K4 moments, K5 warp
floor, K6 trip update, K7 level set-up) against their plain PyTorch versions (K1 and K3
also on the row shards of the row-tiled solver), and its entry points (align, the
benchmark, the eval harness, the row-tiled solver on two gloo ranks that
share the card), on a CUDA device.

Every test needs a CUDA device and nvcc, and skips without them. The file
imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: moments normalized by max(|ref|, 1) at atol 2e-4, warps of
0..255 images at atol 2e-3 (float32 sums taken in another order), NaN
positions equal; reruns bitwise equal (no atomics on any result). K6 on
systems that assemble exactly (tests/trip_cases.py): flags, counts and
iterations equal, p, error, lambda and the motion matrices within 1e-6 of
max(|ref|, 1) (the norm and the 3x3 product sum in another order). K7:
the packed images and gradients bitwise equal to the set-up's op chain; the
gradient moments sum their C products in channel order, ATen's `.sum(-1)`
in its own, so each is held within 2(C - 1) units of 2^-24 of the sum of
the products' magnitudes (a float32 sum of C terms, in any order, lies
within (C - 1) of them of the exact sum), exact at C = 1.
"""

import collections

import numpy as np
import pytest
import torch

import inverse_compositional_algorithm_tpu_torch as ica
from inverse_compositional_algorithm_tpu_torch.ops import gradients, normal_equations
from inverse_compositional_algorithm_tpu_torch.models import ic as tic
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as k1
from inverse_compositional_algorithm_tpu_torch.ops.kernels import level_pack as k7
from inverse_compositional_algorithm_tpu_torch.ops.kernels import normal_eq as k4
from inverse_compositional_algorithm_tpu_torch.ops.kernels import trip_update as k6
from inverse_compositional_algorithm_tpu_torch.ops.kernels import warp as k3
from inverse_compositional_algorithm_tpu_torch.ops.kernels import warp_floor as k5
from trip_cases import KINDS, MAX_ITER, SINGULAR_STEP, clone_state, trip_case

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
    "affine": (T.AFFINITY, [1.0, -1.0, 0.05, -0.02, 0.08, -0.04]),
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


def k1_plan(b, h, w, delta, dev, c=3):
    i1 = rand((b, h, w, c), 2, dev)
    i2 = rand((b, h, w, c), 3, dev)
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


@pytest.mark.parametrize("robust,nan", [(R.LORENTZIAN, True), (R.LORENTZIAN, False),
                                        (None, True), (None, False)],
                         ids=["lorentzian", "lorentzian_nan_false", "quadratic",
                              "quadratic_nan_false"])
@pytest.mark.parametrize("c", [1, 2, 4])
def test_fused_iter_channels(cuda, c, robust, nan):
    """K1's one-channel instance (C = 1) and its generic one (every other C
    but 3: `fused_iter_kernel<0>`, which a four-band tile takes) against
    the plain version at a ragged shape, robust and quadratic, both
    nanifoutside forms; reruns bitwise equal."""
    b, h, w, delta = 2, 49, 73, 4
    plan = k1_plan(b, h, w, delta, cuda, c=c)
    lam = torch.tensor([5.0, 17.0], device=cuda)
    args = (plan.i2p, plan.tplp, *motion(*MOTIONS["affine"], b, cuda), lam, h, w, robust, nan,
            delta)
    got = k1.fused_iter_moments(*args)
    normalized_close(got, k1.fused_iter_moments_ref(*args))
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
    and every rank launched K1 and not K7 (a band's gradients need its
    neighbours' rows)."""
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
        assert o["launches"]["fused_iter_moments"] > 0 and o["launches"]["level_pack"] == 0
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
    plan = k1_plan(1, 16, 24, 2, cuda)
    mat = torch.eye(3, device=cuda)[None]
    with pytest.raises(TypeError):
        k1.fused_iter_moments(plan.i2p.double(), plan.tplp, mat, False, 5.0, 16, 24,
                              R.CHARBONNIER, True, 2)
    # The ablation variants: C = 3 on a robust loss only, built knob sets only.
    gray = k1.plan_fused_iter(*(rand((1, 16, 24, 1), s, cuda) for s in (1, 2, 3, 4)),
                              *(rand((1, 16, 24), s, cuda) for s in (5, 6, 7)))
    before = k1.ABLATE_LAUNCHES
    for p, robust, ablate in [(gray, R.CHARBONNIER, ""), (plan, None, ""),
                              (plan, R.CHARBONNIER, "nomask,norho"),
                              (plan, R.CHARBONNIER, "chunk2")]:
        with pytest.raises(ValueError):
            k1.fused_iter_moments_ablate(p.i2p, p.tplp, mat, False, 5.0, 16, 24, robust, True,
                                         2, ablate=ablate)
    assert k1.ABLATE_LAUNCHES == before


@pytest.mark.parametrize("dtype,precondition", [(torch.float64, True), (torch.float64, False),
                                                (torch.float32, False)])
def test_align_plain_configs_run_on_cuda(cuda, dtype, precondition):
    """float64 and precondition=False run on the card through the plain op
    chain, as JAX runs its XLA chain for them: no K1, K6 or K7 (and no K3
    for float64), and the CPU plain path's result, at 1e-9 on p in float64.
    float32 sums run in another order on the card, so the float32 case is
    held at 1e-2 px of corner displacement, as test_align_on_cuda_matches_cpu."""
    base = torch.tensor(np.random.default_rng(7).uniform(0, 255, (1, 97, 146, 3)), dtype=dtype)
    base = ica.ops.pyramid.gaussian_blur(base, 2.0)
    p = torch.tensor([[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5]], dtype=dtype)
    i1 = ica.ops.warp.bicubic_sample(base, *ica.transform_grid(p, T.HOMOGRAPHY, 97, 146))
    cfg = ica.AlignConfig(transform=T.HOMOGRAPHY, robust=R.CHARBONNIER, nscales=3,
                          precondition=precondition)
    for m in (k1, k3, k4, k6, k7):
        m.LAUNCHES = 0
    gpu = ica.align(i1.to(cuda), base.to(cuda), cfg, dtype=dtype)
    assert gpu.p.is_cuda and gpu.p.dtype == dtype and gpu.iw.is_cuda
    assert (k1.LAUNCHES, k4.LAUNCHES, k6.LAUNCHES, k7.LAUNCHES) == (0, 0, 0, 0)
    assert k3.LAUNCHES == (1 if dtype == torch.float32 else 0)
    cpu = ica.align(i1, base, cfg, dtype=dtype)
    assert torch.equal(gpu.niters.cpu(), cpu.niters)
    if dtype == torch.float64:
        assert float((gpu.p.cpu() - cpu.p).abs().max()) <= 1e-9
    else:
        xs, ys = [0.0, 145.0, 0.0, 145.0], [0.0, 0.0, 96.0, 96.0]
        ax, ay = ica.ops.transforms.transform_points(gpu.p.cpu().double(), T.HOMOGRAPHY, xs, ys)
        bx, by = ica.ops.transforms.transform_points(cpu.p.double(), T.HOMOGRAPHY, xs, ys)
        assert float(torch.hypot(ax - bx, ay - by).max()) <= 1e-2


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


@pytest.mark.parametrize("c", [1, 4])
def test_align_channels_on_cuda_matches_cpu(cuda, c):
    """A gray align() and a four-band one (K1's `<1>` and `<0>` instances),
    AFFINITY with the annealed LORENTZIAN loss, on CUDA within 1e-2 px of
    corner displacement of the CPU plain path, divergence flags equal."""
    base = torch.tensor(np.random.default_rng(11).uniform(0, 255, (1, 97, 146, c)),
                        dtype=torch.float32)
    base = ica.ops.pyramid.gaussian_blur(base, 2.0)
    p = torch.tensor([[1.5, -1.0, 0.01, -0.006, 0.008, -0.01, 0.0, 0.0]])
    i1 = ica.ops.warp.bicubic_sample(base, *ica.transform_grid(p, T.AFFINITY, 97, 146))
    cfg = ica.AlignConfig(transform=T.AFFINITY, robust=R.LORENTZIAN, nscales=3)
    k1.LAUNCHES = k3.LAUNCHES = 0
    gpu = ica.align(i1.to(cuda), base.to(cuda), cfg)
    assert k1.LAUNCHES > 0 and k3.LAUNCHES == 1
    cpu = ica.align(i1, base, cfg)
    xs, ys = [0.0, 145.0, 0.0, 145.0], [0.0, 0.0, 96.0, 96.0]
    ax, ay = ica.ops.transforms.transform_points(gpu.p.cpu().double(), cfg.transform, xs, ys)
    bx, by = ica.ops.transforms.transform_points(cpu.p.double(), cfg.transform, xs, ys)
    assert float(torch.hypot(ax - bx, ay - by).max()) <= 1e-2
    assert torch.equal(gpu.diverged.cpu(), cpu.diverged)


def test_spans_share_the_device_clock(cuda):
    """Under torch.profiler the program's spans and the card's kernels share
    one clock: every K1 kernel of a call lies inside the device-side image
    of an `ica.trip.system` span, each image starts no earlier than its host
    span, and the call's `ica.trip` spans number its K1 launches.

    The profiler maps the card's timestamps onto the host's clock, and the
    two drift apart over a window; how far shows where a kernel reads as
    starting before the runtime call that launched it, which no kernel can.
    An image may precede its span by that much, and that much is held
    under a millisecond, a tenth of a trip at the benchmark's sizes."""
    base = ica.ops.pyramid.gaussian_blur(rand((1, 97, 146, 3), 7, "cpu"), 2.0)
    p = torch.tensor([[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5]])
    i1 = ica.ops.warp.bicubic_sample(base, *ica.transform_grid(p, T.HOMOGRAPHY, 97, 146))
    i1, i2 = i1.expand(4, -1, -1, -1).to(cuda), base.expand(4, -1, -1, -1).to(cuda)
    cfg = ica.AlignConfig(transform=T.HOMOGRAPHY, robust=R.CHARBONNIER, nscales=3)
    ica.align(i1, i2, cfg)
    torch.cuda.synchronize()
    before = k1.LAUNCHES
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ica.align(i1, i2, cfg)
        torch.cuda.synchronize()
    launches = k1.LAUNCHES - before
    host, images, kernels, launched, started = {}, [], [], {}, []
    for ev in prof.profiler.kineto_results.events():
        row = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            host.setdefault(ev.name(), []).append(row)
            if not ev.is_user_annotation() and ev.name().startswith("cu"):
                launched[ev.correlation_id()] = row[0]
        elif ev.name() == "ica.trip.system":
            images.append(row)
        elif not ev.is_user_annotation():
            started.append((ev.correlation_id(), row[0]))
            if "fused_iter_kernel" in ev.name():
                kernels.append(row)
    slack = max([0] + [launched[c] - t for c, t in started if c in launched])
    print(f"{launches} K1 launches, {len(host.get('ica.trip', []))} ica.trip spans, "
          f"{len(images)} ica.trip.system images, {len(kernels)} K1 kernels, "
          f"clock slack {slack} ns")
    assert launches > 0 and len(host["ica.trip"]) == launches
    assert len(kernels) == launches
    assert len(images) == len(host["ica.trip.system"]) == launches
    assert slack < 1_000_000
    for (hs, _), (ds, de) in zip(sorted(host["ica.trip.system"]), sorted(images)):
        assert hs - slack <= ds < de
    for ks, ke in kernels:
        assert any(ds <= ks and ke <= de for ds, de in images)


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


def test_warp_floor_on_a_second_card(cuda):
    """K5 sizes its persistent grid per card: on cuda:1 after cuda:0 it
    still agrees with its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    for dev in (torch.device("cuda:0"), torch.device("cuda:1"), torch.device("cuda:0")):
        img = rand((8, 3, 388, 584), 8, dev)
        got = k5.warp_floor(img)
        assert got.device == dev
        assert float((got - k5.warp_floor_ref(img)).abs().max()) <= WARP_TOL


def _bench_plan(b, dev):
    """K1's operands on `b` bench pairs (the flagship shape, delta 10)."""
    from inverse_compositional_algorithm_tpu_torch.eval import benchmarks

    i1, i2, p0, _, _, ix, iy, g3 = benchmarks.hot_state(b, 388, 584, T.HOMOGRAPHY)
    plan = k1.plan_fused_iter(i1, i2, ix, iy, *g3, robust=True)
    mat = ica.params_to_matrix(p0, T.HOMOGRAPHY).contiguous()
    return (plan.i2p, plan.tplp, mat, True, torch.full((b,), 5.0, device=dev), 388, 584,
            R.CHARBONNIER, True, 10)


def test_fused_iter_ablate_variants(cuda):
    """The full, nomask and nofold variants give the production K1's
    moments bit for bit at delta 10; every other variant is finite, repeats
    bit for bit and differs from the full one."""
    from inverse_compositional_algorithm_tpu_torch.eval.attr_bench import HOPPER

    args = _bench_plan(2, cuda)
    prod = k1.fused_iter_moments(*args)
    before, n = k1.ABLATE_LAUNCHES, 0
    for name, hop in HOPPER.items():
        if hop is None:
            continue
        got = k1.fused_iter_moments_ablate(*args, ablate=name)
        again = k1.fused_iter_moments_ablate(*args, ablate=hop)
        n += 2
        assert bitwise_equal(got, again), name
        if hop in ("", "nomask", "nofold"):
            assert bitwise_equal(got, prod), name
        else:
            assert bool(torch.isfinite(got).all()) and not torch.equal(got, prod), name
    assert k1.ABLATE_LAUNCHES == before + n == before + 18


def test_attr_bench_run(cuda):
    from inverse_compositional_algorithm_tpu_torch.eval import attr_bench

    rows = attr_bench.run(batch=2, variants=["", "noepi", "chunk2",
                                             "nomask,chunk2,cheapwy,nofold"])
    full = rows["(full)"]
    assert full["device_ms"] > 0 and full["cold_device_ms"] > 0 and full["delta_ms"] is None
    assert rows["noepi"]["device_ms"] > 0 and rows["noepi"]["delta_ms"] is not None
    assert "not_applicable" in rows["chunk2"]
    assert rows["nomask,chunk2,cheapwy,nofold"]["hopper"] == "nomask,cheapwy,nofold"
    assert rows["vpu_floor"]["device_ms"] > 0 and rows["vpu_floor"]["full_over_floor"] > 0


def test_stabilize_torch_on_cuda(cuda):
    """The walkthrough on the card lands within 1e-2 px of corner
    displacement of the ground-truth jitter, through K1 and K3."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "stabilize_torch.py")
    spec = importlib.util.spec_from_file_location("stabilize_torch", path)
    stab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stab)
    for m in (k1, k3):
        m.LAUNCHES = 0
    est = stab.main(device="cuda")
    assert k1.LAUNCHES > 0 and k3.LAUNCHES == 1
    _, gt = stab.make_sequence(device="cpu")
    t = T.EUCLIDEAN
    xs, ys = [0.0, 383.0, 0.0, 383.0], [0.0, 0.0, 287.0, 287.0]
    ax, ay = ica.ops.transforms.transform_points(
        ica.pad_params(torch.tensor(est, dtype=torch.float64), t), t, xs, ys)
    bx, by = ica.ops.transforms.transform_points(
        ica.pad_params(torch.tensor(gt[:, :3], dtype=torch.float64), t), t, xs, ys)
    assert float(torch.hypot(ax - bx, ay - by).max()) <= 1e-2


def test_layers_on_cuda(cuda):
    """The reference-signature shims run on the card: K1 and K3 always, K4
    on the quadratic ones; numpy input goes to CUDA by default."""
    from inverse_compositional_algorithm_tpu_torch.models import layers

    base = ica.ops.pyramid.gaussian_blur(rand((1, 97, 146, 3), 7, "cpu"), 2.0)
    p_gt = [1.2, -0.8, 0.015]
    gx, gy = ica.transform_grid(ica.pad_params(torch.tensor([p_gt]), T.EUCLIDEAN),
                                T.EUCLIDEAN, 97, 146)
    i1 = ica.ops.warp.bicubic_sample(base, gx, gy)[0].numpy()
    i2 = base[0].numpy()
    for shim, quadratic in [(layers.InverseCompositional(), True),
                            (layers.RobustInverseCompositional(), False),
                            (layers.PyramidalInverseCompositional(), True)]:
        for m in (k1, k3, k4):
            m.LAUNCHES = 0
        p, err, di, iw = shim((i1, i2))
        assert p.is_cuda and iw.is_cuda and di.is_cuda
        assert k1.LAUNCHES > 0 and k3.LAUNCHES == 1 and (k4.LAUNCHES > 0) == quadratic
        assert float((p.cpu() - torch.tensor(p_gt)).abs().max()) <= 1e-3


def _close(got, ref, what):
    n = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max()) / n
    assert err <= 1e-6, f"{what}: {err}"


@pytest.mark.parametrize("bsz", [1, 37, 1024])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ttype", list(T), ids=[t.name for t in T])
def test_trip_update(cuda, ttype, kind, bsz):
    """K6 against trip_update_ref on the same moments and state: some pairs
    already inactive, a singular H (dp = 0), a pair off the frame (reverts
    to p0, diverged), a zero homogeneous scale (p kept), and the last
    iteration (no pair goes on); the count in its slot, the other slot
    zeroed; reruns bitwise equal."""
    for it in (3, MAX_ITER - 1):
        m, s, plan, (h, b) = trip_case(ttype, kind, bsz, seed=11 + bsz, it=it, device=cuda)
        want = k6.trip_update_ref(h, b, s, plan)
        runs = []
        for _ in range(2):
            got = clone_state(s)
            plan.count[it % 2] = 0          # the slot this trip adds into
            plan.count[1 - it % 2] = 7      # the last trip's count
            before = k6.LAUNCHES
            k6.trip_update(m, got, plan)
            torch.cuda.synchronize()
            assert k6.LAUNCHES == before + 1
            runs.append((got, plan.mat.clone(), plan.count.clone()))
        (got, mat, count), (again, mat2, count2) = runs
        for name, w in zip(("p", "error", "lam", "niters", "active", "diverged"), want):
            g = getattr(got, name)
            assert torch.equal(g, getattr(again, name)), f"{name}: reruns differ"
            if g.is_floating_point():
                _close(g, w, name)
            else:
                assert torch.equal(g, w), name
        assert torch.equal(mat, mat2) and torch.equal(count, count2)
        _close(mat, ica.params_to_matrix(want[0], ttype), "mat")
        cur = it % 2
        assert int(count[cur]) == int(want[4].sum()) and int(count[1 - cur]) == 0
        assert k6.still_count(plan, it) == int(want[4].sum())
        if it == MAX_ITER - 1:
            assert not bool(got.active.any())
        if bsz >= 3:
            assert float(got.error[0]) == 0.0
            assert bool(got.diverged[1]) and torch.equal(got.p[1], plan.p0[1])
            if kind == "quadratic" and ttype in SINGULAR_STEP:
                assert torch.equal(got.p[2], s.p[2]) and float(got.error[2]) == 1.0


def span_kernels(prof, span=None) -> list:
    """Names of the kernels a profile holds (copies and sets left out), one
    list for each host span named `span` (those launched while it was open),
    or one list of all of them when `span` is None."""
    spans, launched, kernels = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if ev.name() == span:
                spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
            elif not ev.is_user_annotation() and ev.name().startswith("cu"):
                launched[ev.correlation_id()] = ev.start_ns()
        elif not ev.is_user_annotation() and not ev.name().startswith(("Memcpy", "Memset")):
            kernels.append((ev.correlation_id(), ev.name()))
    if span is None:
        return [[n for _, n in kernels]]
    return [[n for cid, n in kernels if a <= launched.get(cid, -1) < b] for a, b in spans]


def test_fused_ic_solve_takes_k6_every_trip(cuda):
    """A kernel-path ic_solve launches K6 once for each K1 launch, every
    trip holds at most 4 kernels (K1, its moment pass, K6), and the result
    is the plain update's on the card within 1e-2 px of corner
    displacement."""
    base = ica.ops.pyramid.gaussian_blur(rand((1, 97, 146, 3), 7, "cpu"), 2.0)
    p = torch.tensor([[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5]])
    i1 = ica.ops.warp.bicubic_sample(base, *ica.transform_grid(p, T.HOMOGRAPHY, 97, 146))
    i1, i2 = i1.expand(4, -1, -1, -1).to(cuda), base.expand(4, -1, -1, -1).to(cuda)
    p0 = torch.zeros((4, 8), device=cuda)
    for robust in (R.CHARBONNIER, R.QUADRATIC):
        kw = dict(robust=robust, delta=5)
        b1, b6 = k1.LAUNCHES, k6.LAUNCHES
        st = ica.ic_solve(i1, i2, p0, T.HOMOGRAPHY, **kw)
        torch.cuda.synchronize()
        assert k1.LAUNCHES - b1 == k6.LAUNCHES - b6 == st.it > 0
        plain = ica.ic_solve(i1.double(), i2.double(), p0.double(), T.HOMOGRAPHY, **kw)
        xs, ys = [0.0, 145.0, 0.0, 145.0], [0.0, 0.0, 96.0, 96.0]
        ax, ay = ica.ops.transforms.transform_points(st.p.double(), T.HOMOGRAPHY, xs, ys)
        bx, by = ica.ops.transforms.transform_points(plain.p, T.HOMOGRAPHY, xs, ys)
        assert float(torch.hypot(ax - bx, ay - by).max()) <= 1e-2
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        st = ica.ic_solve(i1, i2, p0, T.HOMOGRAPHY, robust=R.CHARBONNIER, delta=5)
        torch.cuda.synchronize()
    per_trip = [len(k) for k in span_kernels(prof, "ica.trip")]
    print(f"{len(per_trip)} trips, kernels a trip {per_trip}")
    assert len(per_trip) == st.it and max(per_trip) <= 4 and min(per_trip) >= 3


def check_level_pack(i1, i2, delta, nanifoutside, robust):
    """K7 against the set-up's op chain (`pack_level_ref`) on the card: the
    packed images and gradients bitwise, the moments within the module
    docstring's bound, a rerun bitwise. Returns the moments' largest
    difference in units of 2^-24 of their magnitude sum."""
    c = i1.shape[-1]
    before = k7.LAUNCHES
    got = k7.pack_level(i1, i2, delta, nanifoutside, robust)
    again = k7.pack_level(i1, i2, delta, nanifoutside, robust)
    assert k7.LAUNCHES == before + 2
    assert bitwise_equal(got.tplp, again.tplp) and bitwise_equal(got.i2p, again.i2p)
    assert (got.gmom is None) == robust
    assert robust or bitwise_equal(got.gmom, again.gmom)
    del again
    ref = k7.pack_level_ref(i1, i2, delta, nanifoutside, robust)
    torch.cuda.synchronize()
    assert got.tplp.shape == ref.tplp.shape and got.i2p.shape == ref.i2p.shape
    assert bitwise_equal(got.i2p, ref.i2p)
    assert bitwise_equal(got.tplp[:, :3 * c], ref.tplp[:, :3 * c])
    assert robust or got.gmom.shape == ref.gmom.shape
    units, _ = k7.moment_gap(got, ref)
    assert units <= 2 * (c - 1), units
    return units


LEVEL_DELTAS = {"delta0": 0, "delta1": 1, "capped": tic.effective_delta(30, 49, 73)}


@pytest.mark.parametrize("delta", list(LEVEL_DELTAS.values()), ids=list(LEVEL_DELTAS))
@pytest.mark.parametrize("nanifoutside", [True, False], ids=["nan", "zero"])
@pytest.mark.parametrize("robust", [True, False], ids=["robust", "quadratic"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_level_pack(cuda, c, robust, nanifoutside, delta):
    """K7 on a ragged 49x73 frame (4-float stores at the frame's right edge),
    K1's `<1>`, `<3>` and generic-channel instances, both losses, both band
    forms, delta 0, 1 and capped."""
    i1, i2 = rand((2, 49, 73, c), 2, cuda), rand((2, 49, 73, c), 3, cuda)
    print(f"moments' largest difference: {check_level_pack(i1, i2, delta, nanifoutside, robust)}"
          " units")


@pytest.mark.parametrize("b,h,w,robust", [(2, 388, 584, True), (1, 1080, 1920, False),
                                          (800, 388, 584, True), (65544, 6, 9, True)],
                         ids=["flagship", "1080p_quadratic", "over_2e31", "over_65535_pairs"])
def test_level_pack_at_size(cuda, b, h, w, robust):
    """K7 on frames whose width takes float4 stores, on a batch whose
    B * P * H * W passes 2^31 (the pairs' 64-bit bases), and on more pairs
    than the grid's z holds (65535: the kernel is launched once per 65535
    pairs, each launch from its own bases)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    i1, i2 = (torch.rand((b, h, w, 3), generator=gen, device=cuda) * 255.0 for _ in range(2))
    if b == 800:
        assert b * 12 * h * w > 2 ** 31
    delta = tic.effective_delta(10, h, w)          # as ic_solve caps it: 1 on the 6x9 frame
    print(f"moments' largest difference: {check_level_pack(i1, i2, delta, True, robust)} units")


def test_fused_ic_solve_packs_once_a_level(cuda):
    """K7 launches once a level of each align call on the kernel path, and a
    profiled level set-up launches K7 and the loop state's kernels (the
    kernel level made and started alone, on a system built beforehand) and
    nothing else: no concatenation and no elementwise pass over the frame."""
    base = ica.ops.pyramid.gaussian_blur(rand((1, 97, 146, 3), 7, "cpu"), 2.0)
    p = torch.tensor([[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5]])
    i1 = ica.ops.warp.bicubic_sample(base, *ica.transform_grid(p, T.HOMOGRAPHY, 97, 146))
    i1, i2 = (t.expand(4, -1, -1, -1).to(cuda).contiguous() for t in (i1, base))
    for cfg in [ica.AlignConfig(transform=T.HOMOGRAPHY, robust=R.CHARBONNIER, nscales=3),
                ica.AlignConfig(nscales=3)]:
        k7.LAUNCHES = 0
        for _ in range(2):
            ica.align(i1, i2, cfg)
        assert k7.LAUNCHES == 2 * cfg.nscales
    p0 = torch.zeros((4, 8), device=cuda)
    kw = dict(robust=R.CHARBONNIER, delta=5)
    ica.ic_solve(i1, i2, p0, T.HOMOGRAPHY, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ica.ic_solve(i1, i2, p0, T.HOMOGRAPHY, **kw)
        torch.cuda.synchronize()
    setup = collections.Counter(n for k in span_kernels(prof, "ica.level.setup") for n in k)
    scale = ica.ops.transforms.param_preconditioner(T.HOMOGRAPHY, 97, 146)
    system = tic._fused_system(k7.pack_level(i1, i2, 5, True, True), T.HOMOGRAPHY, R.CHARBONNIER,
                               True, 5, scale)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        plan = k6.plan_trip(ica.pad_params(p0).contiguous(), T.HOMOGRAPHY, 97, 146, tol=1e-3,
                            max_iter=30, anneal=True, scale=scale, divergence_guard=True)
        tic._KernelLevel(system, plan, 0.0).start()
        torch.cuda.synchronize()
    loop = collections.Counter(span_kernels(prof)[0])
    print(f"set-up kernels {dict(setup)}; the loop state's {dict(loop)}")
    packing = setup - loop
    assert not loop - setup
    assert len(packing) == 1 and sum(packing.values()) == 1
    assert "level_pack_kernel" in next(iter(packing))


CELL_SHAPES = {
    "homography_charbonnier.584x388": (T.HOMOGRAPHY, R.CHARBONNIER, 388, 584),
    "euclidean_quadratic.1080p": (T.EUCLIDEAN, R.QUADRATIC, 1080, 1920),
    "homography_charbonnier.1080p": (T.HOMOGRAPHY, R.CHARBONNIER, 1080, 1920),
    "euclidean_quadratic.584x388": (T.EUCLIDEAN, R.QUADRATIC, 388, 584),
}


@pytest.mark.parametrize("cell", list(CELL_SHAPES))
def test_align_with_k7_matches_the_chain(cuda, monkeypatch, cell):
    """align() with K7 packing each level lands within the benchmark's
    p_gap_px limit (1e-3 px of corner displacement) of align() with the
    set-up's op chain on the card, in the configurations and frame sizes
    of the benchmark's cells; divergence flags equal."""
    ttype, robust, h, w = CELL_SHAPES[cell]
    cfg = ica.AlignConfig(transform=ttype, robust=robust, lam=0.0, nscales=5, nu=0.5, delta=10)
    base = ica.ops.pyramid.gaussian_blur(rand((1, h, w, 3), 21, cuda), 2.0)
    p = {T.HOMOGRAPHY: [[0.003, -0.002, 2.5, 0.002, -0.003, -1.5, 2e-6, -1e-6],
                        [-0.002, 0.001, -3.0, 0.001, 0.002, 2.0, -1e-6, 2e-6]],
         T.EUCLIDEAN: [[2.5, -1.5, 0.004], [-3.0, 2.0, -0.003]]}[ttype]
    pp = ica.pad_params(torch.tensor(p, device=cuda))
    i1 = ica.ops.warp.bicubic_sample(base.expand(2, h, w, 3), *ica.transform_grid(pp, ttype, h, w))
    i2 = base.expand(2, h, w, 3).contiguous()
    k7.LAUNCHES = 0
    got = ica.align(i1, i2, cfg)
    assert k7.LAUNCHES == cfg.nscales
    monkeypatch.setattr(tic, "pack_level", k7.pack_level_ref)
    want = ica.align(i1, i2, cfg)
    assert k7.LAUNCHES == cfg.nscales
    xs, ys = [0.0, w - 1.0, 0.0, w - 1.0], [0.0, 0.0, h - 1.0, h - 1.0]
    ax, ay = ica.ops.transforms.transform_points(got.p.double(), ttype, xs, ys)
    bx, by = ica.ops.transforms.transform_points(want.p.double(), ttype, xs, ys)
    gap = float(torch.hypot(ax - bx, ay - by).max())
    print(f"{cell}: corner gap {gap} px, niters {got.niters.tolist()} / {want.niters.tolist()}")
    assert gap <= 1e-3
    assert torch.equal(got.diverged, want.diverged)
