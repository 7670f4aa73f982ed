"""The port's scale-out layer (`parallel/`) on the CPU, against the JAX
package's `parallel/` on the conftest 8-device mesh.

Ranks are spawned through `parallel.spawn.run_ranks` (gloo on the CPU),
each run under its own deadline; one spawn of 4 ranks serves every
solver case (module fixture `port_runs`). Inputs are numpy arrays made
from seeds and shared by both sides.

Tolerances: float64 on both sides, atol 1e-9 on p (sums over ~5000
pixels taken in another order, iterated up to 30 times; JAX's own tiled
and single-device solves agree to ~1e-14 here), equal niters and
diverged flags, lambda at rtol 1e-9; gradients of a row band at atol
1e-12 (the same differences); the moments of row shards against the
whole frame's at 1e-9 relative (a sum split into 2 or 4 parts).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.models.api import align as j_align
from inverse_compositional_algorithm_tpu.ops.gradients import (
    boundary_band_mask as j_band,
    central_gradients as j_central,
)
from inverse_compositional_algorithm_tpu.parallel.mesh import make_mesh as j_make_mesh
from inverse_compositional_algorithm_tpu.parallel.tiled import (
    tiled_ic_solve as j_tiled_ic_solve,
    tiled_pyramidal_solve as j_tiled_pyramidal_solve,
)
import inverse_compositional_algorithm_tpu as jica
import inverse_compositional_algorithm_tpu_torch as tica
from inverse_compositional_algorithm_tpu_torch.models import ic as tic
from inverse_compositional_algorithm_tpu_torch.ops import normal_equations as tne
from inverse_compositional_algorithm_tpu_torch.ops.kernels import fused_iter as k1
from inverse_compositional_algorithm_tpu_torch.parallel import scaling, tiled
from inverse_compositional_algorithm_tpu_torch.parallel.ranks import drive, run_launch
from inverse_compositional_algorithm_tpu_torch.parallel.spawn import raise_on_rank, run_ranks

torch.set_num_threads(1)

T = tica.TransformType
R = tica.RobustLoss
DEADLINE = 150.0          # seconds, every multi-process run


def smooth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = torch.tensor(rng.uniform(0, 255, (1, h, w, 3)), dtype=torch.float64)
    return tica.ops.pyramid.gaussian_blur(img, 2.0)[0].numpy()


def warped(img, p, ttype):
    """img sampled at x'(x; p): aligning it to img recovers p."""
    h, w, _ = img.shape
    pp = tica.pad_params(torch.tensor([p], dtype=torch.float64), ttype)
    gx, gy = tica.transform_grid(pp, ttype, h, w)
    return tica.ops.warp.bicubic_sample(torch.tensor(img[None]), gx, gy)[0].numpy()


def pair_batch(make_pair, p_gt, ttype, h=64, w=80):
    """tests/test_tiled.py's batch: the conftest pair, cropped, twice, float64."""
    i1, i2 = make_pair(p_gt, jica.TransformType[ttype.name])
    i1 = np.broadcast_to(i1[None, :h, :w], (2, h, w, 3)).astype(np.float64)
    i2 = np.broadcast_to(i2[None, :h, :w], (2, h, w, 3)).astype(np.float64)
    return i1, i2, np.zeros((2, 8))


def diverged_batch():
    """Pair 0 aligns; pair 1 starts 5 widths off, so the guard trips
    (tests/test_tiled.py:138-169)."""
    img = smooth(48, 64)
    i1 = np.stack([warped(img, [1.5, -1.0], T.TRANSLATION), img])
    p0 = np.zeros((2, 8))
    p0[1, 0] = 5.0 * 64
    return i1, np.stack([img, img]), p0


def lambda_batch():
    """Pair 0 is aligned already, pair 1 moved: lambda anneals per pair
    (tests/test_tiled.py:172-207)."""
    img = smooth(48, 64)
    return np.stack([img, warped(img, [2.5, -2.0], T.TRANSLATION)]), np.stack([img, img]), \
        np.zeros((2, 8))


HOMOG = [0.01, 0.002, 1.0, -0.001, 0.005, 0.5, 2e-5, -3e-5]
SOLVE_CASES = {   # name: (batch, transform, solver keywords)
    "translation_quadratic": ("pair", [1.5, -1.0], T.TRANSLATION, dict(delta=8)),
    "translation_charbonnier": ("pair", [1.5, -1.0], T.TRANSLATION,
                                dict(delta=8, robust=R.CHARBONNIER)),
    "homography_quadratic": ("pair", HOMOG, T.HOMOGRAPHY, dict(delta=8)),
    "homography_charbonnier": ("pair", HOMOG, T.HOMOGRAPHY, dict(delta=8, robust=R.CHARBONNIER)),
    "diverged": ("diverged", None, T.TRANSLATION, dict(delta=3)),
    "per_pair_lambda": ("lambda", None, T.TRANSLATION, dict(delta=3, robust=R.CHARBONNIER)),
}
PYRAMID = dict(nscales=3, delta=6, robust=R.CHARBONNIER)   # 72 -> 36 -> 18 rows
ALIGN_CFG = dict(transform=T.HOMOGRAPHY, robust=R.CHARBONNIER, nscales=2, delta=6)


def solve_inputs(make_pair, name):
    kind, p_gt, ttype, _ = SOLVE_CASES[name]
    if kind == "pair":
        return pair_batch(make_pair, p_gt, ttype)
    return diverged_batch() if kind == "diverged" else lambda_batch()


def align_inputs():
    """4 pairs of a smooth 64x72 image under small homographies."""
    img = smooth(64, 72, seed=3)
    ps = [[0.01, -0.005, 1.5, 0.008, -0.01, -1.0, 5e-5, -3e-5],
          [-0.012, 0.004, -2.0, -0.006, 0.009, 1.25, -4e-5, 2e-5],
          [0.0, 0.01, 0.5, -0.01, 0.0, 0.75, 0.0, 3e-5],
          [0.005, 0.0, -1.0, 0.0, 0.005, -0.5, 2e-5, 0.0]]
    i1 = np.stack([warped(img, p, T.HOMOGRAPHY) for p in ps])
    return i1, np.stack([img] * 4)


def j_args(i1, i2, p0):
    return jnp.asarray(i1), jnp.asarray(i2), jnp.asarray(p0)


def j_kw(kw):
    out = dict(kw)
    if "robust" in out:
        out["robust"] = jica.RobustLoss[out["robust"].name]
    return out


@pytest.fixture(scope="module")
def port_runs(make_pair):
    """Every solver case on 4 CPU ranks in one spawn: tiled_ic_solve on a
    1x4 mesh, tiled_pyramidal_solve on 1x4, align_sharded on 2x2."""
    cases, args = {}, {}
    for name, (_, _, ttype, kw) in SOLVE_CASES.items():
        cases[name] = {"entry": "tiled_ic_solve", "mesh": (1, 4), "kwargs": dict(ttype=ttype, **kw)}
        args.update(zip((f"{name}.i1", f"{name}.i2", f"{name}.p0"), solve_inputs(make_pair, name)))
    i1, i2, p0 = pair_batch(make_pair, [3.0, -2.0], T.TRANSLATION, h=72)
    cases["pyramid"] = {"entry": "tiled_pyramidal_solve", "mesh": (1, 4),
                        "kwargs": dict(ttype=T.TRANSLATION, **PYRAMID)}
    args.update({"pyramid.i1": i1, "pyramid.i2": i2, "pyramid.p0": p0})
    i1, i2 = align_inputs()
    cases["align"] = {"entry": "align_sharded", "mesh": (2, 2),
                      "kwargs": dict(config=tica.AlignConfig(**ALIGN_CFG), tile_rows=True,
                                     dtype=torch.float64)}
    args.update({"align.i1": i1, "align.i2": i2})
    outs = run_ranks(drive, 4, device="cpu", timeout_s=DEADLINE, args=args,
                     kwargs={"cases": cases}, threads=1)
    return [o["out"] for o in outs], args


def tile_group_result(outs, name, fields=("p", "error", "lam", "niters", "diverged")):
    """The case's per-pair fields, checked equal on every rank of the tile group."""
    got = {f: outs[0][f"{name}.{f}"] for f in fields}
    for o in outs[1:]:
        for f in fields:
            np.testing.assert_array_equal(o[f"{name}.{f}"], got[f])
    return got


@pytest.mark.parametrize("name", list(SOLVE_CASES))
def test_tiled_ic_solve_matches_jax(port_runs, make_pair, name):
    outs, _ = port_runs
    _, _, ttype, kw = SOLVE_CASES[name]
    got = tile_group_result(outs, name)
    want = j_tiled_ic_solve(*j_args(*solve_inputs(make_pair, name)),
                            jica.TransformType[ttype.name], mesh=j_make_mesh(pairs=2, tile=4),
                            **j_kw(kw))
    np.testing.assert_allclose(got["p"], np.asarray(want.p), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got["niters"], np.asarray(want.niters))
    np.testing.assert_array_equal(got["diverged"], np.asarray(want.diverged))
    np.testing.assert_allclose(got["lam"], np.asarray(want.lam), rtol=1e-9)
    assert all(o[f"{name}.it"] == int(want.it) for o in outs)
    if name == "diverged":
        assert got["diverged"].tolist() == [False, True] and got["niters"][1] <= 2
        np.testing.assert_array_equal(got["p"][1], solve_inputs(make_pair, name)[2][1])
    if name == "per_pair_lambda":
        n0, n1 = got["niters"]
        assert n0 < n1
        for lam, n in zip(got["lam"], (n0, n1)):
            np.testing.assert_allclose(lam, max(tica.LAMBDA_0 * tica.LAMBDA_RATIO ** n,
                                                tica.LAMBDA_N), rtol=1e-9)


def test_tiled_pyramidal_solve_matches_jax(port_runs):
    """72 rows over 3 scales: 72 and 36 tile 4 ways, 18 does not and runs
    whole on every rank (the fallback), and the warm start crosses."""
    outs, args = port_runs
    got = tile_group_result(outs, "pyramid")
    assert outs[0]["pyramid.levels"] == 3
    want, per = j_tiled_pyramidal_solve(
        *j_args(args["pyramid.i1"], args["pyramid.i2"], args["pyramid.p0"]),
        jica.TransformType.TRANSLATION, mesh=j_make_mesh(pairs=2, tile=4), **j_kw(PYRAMID))
    assert len(per) == 3
    np.testing.assert_allclose(got["p"], np.asarray(want.p), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got["niters"], np.asarray(want.niters))
    np.testing.assert_array_equal(got["diverged"], np.asarray(want.diverged))


def test_align_sharded_matches_jax_align(port_runs):
    """Pairs 2 x tile 2: every rank gathers all 4 pairs' results, equal to
    JAX align per pair; each rank's rows of Iw are JAX's rows."""
    outs, args = port_runs
    cfg = jica.AlignConfig(transform=jica.TransformType.HOMOGRAPHY,
                           robust=jica.RobustLoss.CHARBONNIER, nscales=2, delta=6)
    want = j_align(args["align.i1"], args["align.i2"], cfg, dtype=jnp.float64)
    for o in outs:
        np.testing.assert_allclose(o["align.p"], np.asarray(want.p), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(o["align.niters"], np.asarray(want.niters))
        np.testing.assert_array_equal(o["align.diverged"], np.asarray(want.diverged))
        pr, tr = o["align.pairs_rank"], o["align.tile_rank"]
        rows = o["align.rows"]
        assert rows == 32
        sl = (slice(2 * pr, 2 * pr + 2), slice(tr * rows, (tr + 1) * rows))
        np.testing.assert_array_equal(o["align.valid"], np.asarray(want.valid)[sl])
        fin = o["align.valid"]
        np.testing.assert_allclose(o["align.iw"][fin], np.asarray(want.iw)[sl][fin], atol=1e-9)
        assert np.isnan(o["align.iw"][~fin]).all()


def band_split(x, nt):
    """Row bands of x [B, H, W, C] with each band's (top, bottom) halo rows."""
    b, h, w, c = x.shape
    rows = h // nt
    zero = torch.zeros((b, w, c), dtype=x.dtype)
    for r in range(nt):
        y0 = r * rows
        top = x[:, y0 - 1] if r > 0 else zero
        bottom = x[:, y0 + rows] if r < nt - 1 else zero
        yield y0, x[:, y0:y0 + rows], top, bottom


@pytest.mark.parametrize("nan,delta", [(True, 6), (False, 6), (True, 0)])
def test_halo_gradients_match_jax(nan, delta):
    """halo_gradients over 4 bands, concatenated, are JAX central_gradients
    with the boundary band on the whole frame."""
    x = torch.tensor(np.random.default_rng(5).uniform(0, 255, (2, 40, 52, 3)))
    parts = [tiled.halo_gradients(loc, top, bot, y0, 40, delta, nan)
             for y0, loc, top, bot in band_split(x, 4)]
    ix = torch.cat([p[0] for p in parts], dim=1).numpy()
    iy = torch.cat([p[1] for p in parts], dim=1).numpy()
    jx, jy = j_central(jnp.asarray(x.numpy()))
    if nan and delta > 0:
        band = np.asarray(j_band(40, 52, delta))[None, :, :, None]
        jx, jy = jx * band, jy * band
    np.testing.assert_allclose(ix, np.asarray(jx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(iy, np.asarray(jy), rtol=0, atol=1e-12)


def k1_plan(h, w, delta, robust=True):
    rng = np.random.default_rng(11)
    i1, i2 = (tica.ops.pyramid.gaussian_blur(torch.tensor(rng.uniform(0, 255, (2, h, w, 3))), 1.5)
              for _ in range(2))
    ix, iy = tica.ops.gradients.central_gradients(i1)
    band = tica.ops.gradients.boundary_band_mask(h, w, delta).double()[None, :, :, None]
    ix, iy = ix * band, iy * band
    return i1, i2, ix, iy, tne.grad_moments(ix, iy)


@pytest.mark.parametrize("nt", [2, 4])
@pytest.mark.parametrize("robust", [R.CHARBONNIER, None], ids=["charbonnier", "quadratic"])
def test_k1_plain_row_shards_sum_to_whole_frame(nt, robust):
    """K1's plain version on row shards with their y_offset: the shards'
    moments sum to the whole frame's (the decomposition the tiled solver
    rests on)."""
    h, w, delta = 48, 60, 5
    i1, i2, ix, iy, g = k1_plan(h, w, delta)
    mat = tica.params_to_matrix(tica.pad_params(torch.tensor([HOMOG, HOMOG], dtype=torch.float64)),
                                T.HOMOGRAPHY)
    lam = torch.tensor([5.0, 17.0])
    rows = h // nt

    def moments(lo, hi):
        plan = k1.plan_fused_iter(i1[:, lo:hi], i2, ix[:, lo:hi], iy[:, lo:hi],
                                  *(m[:, lo:hi] for m in g))
        return k1.fused_iter_moments(plan.i2p, plan.tplp, mat, True, lam, h, w, robust, True,
                                     delta, y_offset=lo)

    whole = moments(0, h)
    parts = sum(moments(r * rows, (r + 1) * rows) for r in range(nt))
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-9,
                               atol=1e-9 * float(whole.abs().max()))


@pytest.mark.parametrize("robust", [R.CHARBONNIER, R.QUADRATIC])
def test_tiled_fused_system_matches_plain_system(robust):
    """The CUDA branch's system (K1 moments -> assembly) on CPU tensors,
    band by band with global rows and summed as the all-reduce would, gives
    the plain branch's H and b, and both give the whole frame's."""
    h, w, delta, nt = 48, 60, 5, 4
    i1, i2, ix, iy, g = k1_plan(h, w, delta)
    p = tica.pad_params(torch.tensor([HOMOG, [0.0] * 8], dtype=torch.float64))
    lam = torch.tensor([5.0, 9.0], dtype=torch.float64)
    scale = tica.ops.transforms.param_preconditioner(T.HOMOGRAPHY, h, w)
    rows = h // nt
    sums = {}

    def fused(*band, **kw):
        plan = k1.plan_fused_iter(*band, robust=robust is not R.QUADRATIC)
        return tic._fused_system(plan, T.HOMOGRAPHY, robust, True, delta, scale, 16384, **kw)

    def plain(*band, **kw):
        return tic._plain_system(*band, T.HOMOGRAPHY, robust, True, delta, scale, 16384, **kw)

    for name, make in (("_fused_system", fused), ("_plain_system", plain)):
        parts = [make(i1[:, r * rows:(r + 1) * rows], i2, ix[:, r * rows:(r + 1) * rows],
                      iy[:, r * rows:(r + 1) * rows], *(m[:, r * rows:(r + 1) * rows] for m in g),
                      y_offset=r * rows, reduce=lambda t: t)(p, lam) for r in range(nt)]
        sums[name] = [sum(part[i] for part in parts) for i in (0, 1)]
    whole = tic._plain_system(i1, i2, ix, iy, *g, T.HOMOGRAPHY, robust, True, delta, scale,
                              16384)(p, lam)
    for a, b in zip(sums["_fused_system"], sums["_plain_system"]):
        n = float(b.abs().max())
        np.testing.assert_allclose(a.numpy() / n, b.numpy() / n, rtol=0, atol=1e-9)
    for a, b in zip(sums["_plain_system"], whole):
        n = float(b.abs().max())
        np.testing.assert_allclose(a.numpy() / n, b.numpy() / n, rtol=0, atol=1e-9)


def launch_on_two_cpu_ranks(tile, batch):
    argv = ["--device", "cpu", "--batch-per-host", str(batch), "--height", "48", "--width",
            "64", "--tile", str(tile), "--nscales", "2", "--repeats", "1"]
    outs = run_ranks(run_launch, 2, device="cpu", timeout_s=DEADLINE, kwargs={"argv": argv})
    return [o["out"] for o in outs]


def test_launch_main_rounds_the_host_batch():
    """--batch-per-host is the host's batch: 3 pairs on a 2-way pairs axis
    round up to 4 (as JAX's launcher), 2 for each pairs group."""
    for rec in launch_on_two_cpu_ranks(1, 3):
        assert rec["hosts"] == 1 and rec["mesh"] == "2x1 pairs x tile"
        assert rec["batch_global"] == 4 and rec["errors_finite"]


def test_launch_main_on_two_cpu_ranks():
    for rec in launch_on_two_cpu_ranks(2, 2):
        assert rec["hosts"] == 1 and rec["devices"] == 2 and rec["mesh"] == "1x2 pairs x tile"
        assert rec["batch_global"] == 2 and rec["errors_finite"]
        assert rec["pairs_per_sec_global"] > 0 and rec["backend"] == "gloo"
        assert rec["device"] == "cpu" and rec["card"] is None
        assert "vs_numpy_baseline" not in rec


def test_measure_weak_scaling_on_cpu():
    rec = scaling.measure_weak_scaling((1, 2), pairs_per_device=2, height=48, width=64,
                                       repeats=1, device="cpu", timeout_s=DEADLINE)
    assert [r["devices"] for r in rec["rows"]] == [1, 2]
    assert [r["batch"] for r in rec["rows"]] == [2, 4]
    assert all(r["errors_finite"] and r["pairs_per_sec"] > 0 for r in rec["rows"])
    assert rec["weak_scaling_efficiency"] > 0 and rec["card"] is None


def test_dryrun_multichip_four_ranks(capsys):
    rec = scaling.dryrun_multichip(4, timeout_s=DEADLINE)
    assert rec["mesh"] == (2, 2)
    assert rec["align_p"].shape == rec["pyramid_p"].shape == rec["solve_p"].shape == (4, 8)
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_failing_rank_raises_within_deadline():
    """Rank 1 raises while ranks 0 and 2 wait in an all-reduce: run_ranks
    kills them and raises with rank 1's traceback, well before its
    deadline."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed(.|\n)*fails on purpose"):
        run_ranks(raise_on_rank, 3, device="cpu", timeout_s=DEADLINE, kwargs={"rank": 1})
    assert time.monotonic() - t0 < DEADLINE / 2


def test_tiled_solver_rejects_bad_bands():
    """Argument checks that need no ranks: a band that is not an nt-way
    split of the frame, and a CUDA-only type on the CUDA path."""

    class OneRankMesh:        # the DeviceMesh surface the checks read
        mesh = torch.zeros((1, 2))
        mesh_dim_names = ("pairs", "tile")

        def get_local_rank(self, axis):
            return 0

    x = torch.zeros((1, 9, 8, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="not divisible"):
        tiled.tiled_ic_solve(x[:, :4], x, torch.zeros((1, 8)), T.TRANSLATION, mesh=OneRankMesh())
    x = torch.zeros((1, 8, 8, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="row band"):
        tiled.tiled_ic_solve(x[:, :3], x, torch.zeros((1, 8)), T.TRANSLATION, mesh=OneRankMesh())



def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a card the scale-out entry points raise (they never fall back
    to the CPU on their own); device="cpu" is the way to the CPU."""
    from inverse_compositional_algorithm_tpu_torch.parallel import launch, sharded

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((1, 16, 24, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded.init_distributed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded.align_sharded(img, img)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--batch-per-host", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling.measure_weak_scaling((1,))
