"""The four-band tile configuration (`sentinel2_affine_lorentzian`: AFFINITY,
annealed LORENTZIAN, 5 scales, C = 4) on the CPU, at 72x96:

- the port's CPU path against the configuration's plain reference
  (benchmark/reference/align_ref_tile.py) on pairs of the cell's own
  traffic generator: in float64 within 1e-6 px of corner displacement,
  with valid masks and divergence flags equal (both compute the same
  float64 algorithm; they differ only in the order of their sums); in
  float32 within the cell's `p_gap_px` limit;
- the tile reference against align_ref, whose bands of rows it sums;
- the port's plain K1 and its align at C = 1, 2 and 4 against the JAX
  package;
- K1's 32-bit offset check at the tile's size: four bands fit, five not;
- the `ica.pyramid.zoom` spans and the readers of the two new metrics.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as jica
import inverse_compositional_algorithm_tpu_torch as tica
from benchmark import harness
from benchmark.reference import align_ref, align_ref_tile
from benchmark.traffic.generate import make_pool
from benchmark.yardstick import spans, trace
from inverse_compositional_algorithm_tpu.ops import normal_equations as jne
from inverse_compositional_algorithm_tpu.ops import transforms as jtr
from inverse_compositional_algorithm_tpu.ops.gradients import boundary_band_mask as j_band
from inverse_compositional_algorithm_tpu.ops.gradients import central_gradients as j_grad
from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample as j_sample
from inverse_compositional_algorithm_tpu.ops.warp import domain_mask as j_domain
from inverse_compositional_algorithm_tpu.models.ic import _masked_residual as j_masked
from inverse_compositional_algorithm_tpu_torch.ops import pyramid as tpyr
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as tfi
from inverse_compositional_algorithm_tpu_torch.ops.kernels import normal_eq as tnq

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL = "sentinel2_affine_lorentzian.tile_b1_10980_4band"
H, W, B = 72, 96, 3
T, R = tica.TransformType, tica.RobustLoss
MOM_TOL = 2e-4


@pytest.fixture(scope="module")
def tile():
    """(cell, uint8 I1, I2 [3, 72, 96, 4]): three pairs of the cell's traffic
    at 72x96."""
    cell = harness.load_cell(CELL)
    mix = dict(cell.mix, height=H, width=W, batch=B, pool=1)
    b = make_pool(mix, cell.config["transform"], 2 ** 33 + 5, torch.device("cpu"))[0]
    return cell, b.i1, b.i2


@pytest.fixture(scope="module")
def reference(tile):
    cell, i1, i2 = tile
    return align_ref_tile.align_ref(i1, i2, cell.config, band_px=1000)


def corner_gap(p, ref):
    """[B]: each pair's corner gap to its nearest reference candidate."""
    gap = align_ref.corner_gap_px(p.double()[ref.pair], ref.p, "AFFINITY", H, W)
    return torch.full((B,), float("inf"), dtype=torch.float64).scatter_reduce(
        0, ref.pair, gap, "amin"), gap


def nearest(p, ref):
    _, gap = corner_gap(p, ref)
    best = torch.full((B,), -1, dtype=torch.long)
    for r in torch.argsort(gap, descending=True).tolist():
        best[ref.pair[r]] = r
    return best


def test_float64_port_matches_the_tile_reference(tile, reference):
    cell, i1, i2 = tile
    cfg = harness.align_config(tica, cell.config)
    got = tica.align(i1, i2, cfg, dtype=torch.float64, device="cpu")
    per_pair, _ = corner_gap(got.p, reference)
    assert float(per_pair.max()) <= 1e-6
    rows = nearest(got.p, reference)
    assert torch.equal(got.valid, reference.valid[rows])
    assert torch.equal(got.diverged, reference.diverged[rows])
    assert not bool(got.diverged.any())
    fin = got.valid[..., None].expand_as(got.iw)
    assert float((got.iw[fin] - reference.iw[rows][fin].double()).abs().max()) <= 1e-4


def test_float32_port_is_near_the_tile_reference(tile, reference):
    """The program's own precision: within the cell's p_gap_px limit."""
    cell, i1, i2 = tile
    lim = json.loads((ROOT / "benchmark/limits" / f"{CELL}.json").read_text())
    got = tica.align(i1, i2, harness.align_config(tica, cell.config), device="cpu")
    per_pair, _ = corner_gap(got.p, reference)
    assert float(per_pair.max()) <= lim["p_gap_px"]
    rows = nearest(got.p, reference)
    both = (got.valid & reference.valid[rows])[..., None].expand_as(got.iw)
    assert float((got.iw - reference.iw[rows]).abs()[both].max()) <= lim["iw_gap"]


@pytest.mark.parametrize("name", ["sentinel2_affine_lorentzian", "homography_charbonnier",
                                  "euclidean_quadratic"])
def test_tile_reference_is_align_ref_in_bands(tile, name):
    """Bands of a few rows, summed: align_ref's answers to float64 rounding,
    its iteration counts, flags and masks exactly, its planes to float32."""
    _, i1, i2 = tile
    cfg = dict(json.loads((ROOT / "benchmark/configs" / f"{name}.json").read_text()),
               nscales=3)
    want = align_ref.align_ref(i1, i2, cfg)
    got = align_ref_tile.align_ref(i1, i2, cfg, band_px=700)
    assert torch.equal(got.pair, want.pair)
    assert float((got.p - want.p).abs().max()) <= 1e-12
    for f in ("niters", "diverged", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    assert got.iw.dtype == got.di.dtype == torch.float32
    for f in ("iw", "di"):
        a, b = getattr(got, f).double(), getattr(want, f)
        assert torch.equal(a.isnan(), b.isnan())
        assert float((a - b).nan_to_num(0.0).abs().max()) <= 2e-5


def test_tile_reference_zoom_operator_is_align_ref_s():
    for n, m in [(97, 49), (12, 6), (1080, 540)]:
        np.testing.assert_allclose(align_ref_tile.zoom_operator(n, m, 0.5),
                                   align_ref.zoom_operator(n, m, 0.5), rtol=0, atol=1e-15)


# ---- against the JAX package ----

def _setup(c, seed):
    rng = np.random.default_rng(seed)
    i1 = rng.uniform(0, 255, (2, 37, 53, c)).astype(np.float32)
    i2 = rng.uniform(0, 255, (2, 37, 53, c)).astype(np.float32)
    return i1, i2


@pytest.mark.parametrize("robust,lam", [(R.LORENTZIAN, 17.0), (None, 0.0)],
                         ids=["lorentzian", "quadratic"])
@pytest.mark.parametrize("c", [1, 2, 4])
def test_plain_k1_matches_jax_channels(c, robust, lam):
    """The port's K1 (plain version) at C = 1, 2, 4 against the JAX op
    chain that the kernel replaces, as assembled H and b."""
    h, w, delta = 37, 53, 4
    p = [1.0, -1.0, 0.05, -0.02, 0.08, -0.04]
    i1n, i2n = _setup(c, seed=c)
    i1 = torch.from_numpy(i1n)
    ix, iy = tica.ops.gradients.central_gradients(i1)
    band = tica.ops.gradients.boundary_band_mask(h, w, delta)[None, ..., None]
    ix, iy = ix * band, iy * band
    plan = tfi.plan_fused_iter(i1, torch.from_numpy(i2n), ix, iy,
                               *tica.ops.normal_equations.grad_moments(ix, iy))
    pp = tica.pad_params(torch.tensor(p, dtype=torch.float32)).expand(2, 8)
    m = tfi.fused_iter_moments(plan.i2p, plan.tplp, tica.params_to_matrix(pp, T.AFFINITY),
                               False, torch.full((2,), lam), h, w, robust, True, delta)

    ji1 = jnp.asarray(i1n)
    jix, jiy = j_grad(ji1)
    jb = j_band(h, w, delta).astype(jnp.float32)[None, ..., None]
    jix, jiy = jix * jb, jiy * jb
    jt = jtr.TransformType.AFFINITY
    gx, gy = jtr.transform_grid(jtr.pad_params(jnp.asarray(p, jnp.float32))[None].repeat(2, 0),
                                jt, h, w)
    di = j_masked(j_sample(jnp.asarray(i2n), gx, gy), j_domain(gx, gy, h, w, delta), ji1, True)
    jx, jy = jtr.jacobian_fields(jt, h, w, dtype=jnp.float32,
                                 scale=jtr.param_preconditioner(jt, h, w))
    rho = (jne.robust_weights(di, jnp.float32(lam), jne.RobustLoss[robust.name])
           if robust is not None else None)
    u, v = jne.residual_moments(jix, jiy, di)
    b_ref = np.asarray(jne.rhs(u, v, jx, jy, weights=rho), np.float64)
    if robust is None:
        b_got = tnq._assemble_b(m, T.AFFINITY, h, w).numpy()
    else:
        h_ref = np.asarray(jne.hessian(*jne.grad_moments(jix, jiy), jx, jy, weights=rho))
        h_got = tnq._assemble_h(m[:, :3], T.AFFINITY, h, w).numpy()
        n = max(1.0, float(np.abs(h_ref).max()))
        assert float(np.abs(h_got - h_ref).max()) / n <= MOM_TOL
        b_got = tnq._assemble_b(m[:, 3:], T.AFFINITY, h, w).numpy()
    n = max(1.0, float(np.abs(b_ref).max()))
    assert float(np.abs(b_got - b_ref).max()) / n <= MOM_TOL


@pytest.mark.parametrize("c", [1, 4])
def test_align_matches_jax_channels(c):
    """align() at C = 1 and 4, AFFINITY with the annealed LORENTZIAN, on the
    CPU against the JAX package's: within 1e-2 px of corner displacement of
    each other and of the ground truth, flags equal, iterations within 1."""
    h, w = 64, 96
    rng = np.random.default_rng(c)
    base = tpyr.gaussian_blur(torch.tensor(rng.uniform(0, 255, (1, h, w, c)),
                                           dtype=torch.float32), 2.0)
    p_gt = torch.tensor([[1.5, -1.0, 0.01, -0.006, 0.008, -0.01, 0.0, 0.0],
                         [-2.0, 0.75, -0.008, 0.004, -0.006, 0.012, 0.0, 0.0]])
    i2 = base.expand(2, h, w, c).contiguous()
    i1 = tica.ops.warp.bicubic_sample(i2, *tica.transform_grid(p_gt, T.AFFINITY, h, w))
    jcfg = jica.AlignConfig(transform=jica.TransformType.AFFINITY,
                            robust=jica.RobustLoss.LORENTZIAN, nscales=3, delta=10)
    want = jica.align(i1.numpy(), i2.numpy(), jcfg)
    got = tica.align(i1, i2, tica.config_from_jax(jcfg), device="cpu")
    xs = torch.tensor([0.0, w - 1.0, 0.0, w - 1.0], dtype=torch.float64)
    ys = torch.tensor([0.0, 0.0, h - 1.0, h - 1.0], dtype=torch.float64)

    def gap(a, b):
        ax, ay = tica.ops.transforms.transform_points(a.double(), T.AFFINITY, xs, ys)
        bx, by = tica.ops.transforms.transform_points(b.double(), T.AFFINITY, xs, ys)
        return float(torch.hypot(ax - bx, ay - by).max())

    assert gap(got.p, torch.tensor(np.asarray(want.p))) <= 1e-2
    assert gap(got.p, p_gt) <= 1e-2
    np.testing.assert_array_equal(got.diverged.numpy(), np.asarray(want.diverged))
    assert np.abs(got.niters.numpy() - np.asarray(want.niters)).max() <= 1


# ---- K1's offsets ----

def test_offset_check_takes_the_four_band_tile():
    """P = 3C + 3 packed planes: 15 at C = 4, 1.81e9 values of a 10980 x
    10980 tile (84% of 2^31) pass; 18 at C = 5 do not."""
    n = 10980
    i1 = torch.zeros((1, 6, 7, 4))
    ix, iy = tica.ops.gradients.central_gradients(i1)
    plan = tfi.plan_fused_iter(i1, i1, ix, iy, *tica.ops.normal_equations.grad_moments(ix, iy))
    assert plan.tplp.shape[1] == 15
    tfi._check_offsets(4, 15, n, n, n, n)
    with pytest.raises(ValueError, match="32-bit offsets"):
        tfi._check_offsets(5, 18, n, n, n, n)


# ---- spans and readers ----

def _zoom_rows(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.name().startswith("ica."))


@pytest.mark.parametrize("nscales", [2, 5])
def test_zoom_spans_per_build_pyramid(nscales):
    img = torch.rand((1, 40, 56, 4))
    rows = _zoom_rows(lambda: tpyr.build_pyramid(img, nscales, 0.5))
    assert [r[0] for r in rows] == ["ica.pyramid.zoom"] * (nscales - 1)


def test_zoom_spans_nest_in_the_pyramid_span():
    img = torch.rand((1, 40, 56, 4)) * 255
    cfg = tica.AlignConfig(transform=T.AFFINITY, robust=R.LORENTZIAN, nscales=3)
    rows = _zoom_rows(lambda: tica.align(img, img, cfg, device="cpu"))
    (pyr,) = [r for r in rows if r[0] == "ica.pyramid"]
    zooms = [r for r in rows if r[0] == "ica.pyramid.zoom"]
    assert len(zooms) == 2 * (cfg.nscales - 1)
    assert all(pyr[1] <= z[1] and z[2] <= pyr[2] for z in zooms)


def _zoom_window(host):
    device = [("gemm_a", 20, 60, 12), ("gemm_b", 70, 80, 65), ("gemm_a", 120, 150, 112),
              ("gemm_b", 160, 165, 155), ("fused_iter_kernel<0>", 300, 400, 250)]
    return spans.from_rows(host, device, calls=1, batch=1, level_niters=[])


def test_zoom_finest_ms_reads_each_builds_first_zoom():
    host = [("ica.align", 0, 500), ("ica.pyramid", 10, 200),
            ("ica.pyramid.zoom", 10, 60), ("ica.pyramid.zoom", 62, 100),
            ("ica.pyramid.zoom", 110, 150), ("ica.pyramid.zoom", 152, 190)]
    sp = _zoom_window(host)
    run = types.SimpleNamespace(cached=lambda key, make: sp,
                                cell=types.SimpleNamespace(config={"nscales": 3}))
    assert harness.load_reader("zoom_finest_ms").read(run) == pytest.approx((40 + 30) * 1e-6)
    bare = _zoom_window([h for h in host if h[0] != "ica.pyramid.zoom"])
    run.cached = lambda key, make: bare      # the parent: no zoom spans
    assert harness.load_reader("zoom_finest_ms").read(run) is None


def test_k1_multiband_roofline_reads_the_generic_instance(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    dev = [("void ica::fused_iter_kernel<0>(ica::K1Args)", 0, 1000),
           ("finalize_kernel", 1000, 1100), ("warp_planar_kernel", 1200, 1300)]
    tr = trace.Trace(trace.Intervals.of(dev), trace.Intervals.of([]),
                     trace.Intervals.of([(trace.SPAN, 0, 2000)]))
    trips = [(H, W, 2), (H // 2, W // 2, 5)]
    run = types.SimpleNamespace(
        trace=tr, device=torch.device("cuda"), pool=[None],
        cell=types.SimpleNamespace(mix={"channels": 4}, config={"robust": "LORENTZIAN"}),
        cached=lambda key, make: trips)
    from benchmark.yardstick import work
    least = sum(max(n * work.fused_iter_bytes(4, h, w, True) / 3350e9,
                    n * h * w * work.fused_iter_flops_per_pixel(4, True) / 67e12)
                for h, w, n in trips)
    got = harness.load_reader("k1_multiband_roofline").read(run)
    assert got == pytest.approx(100.0 * least / 1100e-9)
    three = [("void ica::fused_iter_kernel<3>(ica::K1Args)", 0, 1000)]
    run.trace = trace.Trace(trace.Intervals.of(three), trace.Intervals.of([]),
                            trace.Intervals.of([(trace.SPAN, 0, 2000)]))
    assert harness.load_reader("k1_multiband_roofline").read(run) is None
