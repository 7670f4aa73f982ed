"""The port's benchmark workload, warp floor (K5), accuracy harness and
eval bank against the JAX package's twins, on the CPU at small sizes.

Inputs are made with numpy from a seed and handed to both sides. The JAX
harness runs its XLA path here (use_pallas=False), so no interpret-mode
Pallas call is made. Tolerances: motion parameters drawn by the same numpy
calls are bit-equal; images sampled by the two bicubic samplers agree to
2e-3 on 0..255 values (float32 summation order); aligned parameters agree
to 1e-2 px of corner displacement (the cross-implementation bar of
test_torch_align.py); blurred textures in 0..255 agree to 1e-3.

The measurement entry points need a CUDA device: here they must raise.
Their runs on the card are in test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as jica
import inverse_compositional_algorithm_tpu_torch as tica
from inverse_compositional_algorithm_tpu.eval import benchmarks as jbm
from inverse_compositional_algorithm_tpu.eval import harness as jhv
from inverse_compositional_algorithm_tpu.eval import run_eval as jre
from inverse_compositional_algorithm_tpu.ops.transforms import transform_points
from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample as j_sample
from inverse_compositional_algorithm_tpu_torch.eval import benchmarks as tbm
from inverse_compositional_algorithm_tpu_torch.eval import harness as thv
from inverse_compositional_algorithm_tpu_torch.eval import profile_stages as tps
from inverse_compositional_algorithm_tpu_torch.eval import run_eval as tre
from inverse_compositional_algorithm_tpu_torch.ops.kernels import warp_floor as k5

torch.set_num_threads(1)

T = tica.TransformType
WARP_ATOL = 2e-3
CORNER_TOL = 1e-2
TEXTURE_ATOL = 1e-3


def corner_err(pa, pb, ttype, h, w):
    jt = jica.TransformType[ttype.name]
    xs = jnp.asarray([0.0, w - 1.0, 0.0, w - 1.0], jnp.float64)
    ys = jnp.asarray([0.0, 0.0, h - 1.0, h - 1.0], jnp.float64)
    ax, ay = transform_points(jnp.asarray(pa, jnp.float64), jt, xs, ys)
    bx, by = transform_points(jnp.asarray(pb, jnp.float64), jt, xs, ys)
    return np.asarray(jnp.hypot(ax - bx, ay - by).max(axis=-1))


@pytest.fixture(scope="module")
def bank():
    """4 distinct 48x64 contents (the port's procedural textures, cut)."""
    return np.stack(tre._procedural_textures(4, 64, seed=3))[:, :48]


# ---- benchmark workload ----

@pytest.mark.parametrize("ttype,hard", [(T.HOMOGRAPHY, False), (T.EUCLIDEAN, True),
                                        (T.TRANSLATION, False)])
def test_make_bench_batch_matches_jax(ttype, hard):
    ti1, ti2, tp = tbm.make_bench_batch(3, 48, 64, ttype, seed=5, hard=hard, device="cpu")
    ji1, ji2, jp = jbm.make_bench_batch(3, 48, 64, jica.TransformType[ttype.name],
                                        seed=5, hard=hard)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(ti2.numpy(), np.asarray(ji2), rtol=0, atol=WARP_ATOL)
    np.testing.assert_allclose(ti1.numpy(), np.asarray(ji1), rtol=0, atol=WARP_ATOL)


def test_fused_iter_byte_model():
    """K1 reads 17 float32 planes per pair on the RGB robust path: 15.4 MB
    at 388x584, so at batch 8 the H100 SXM's 3.35 TB/s bounds it (36.8 us)
    well above its arithmetic at 67 TFLOP/s."""
    assert tbm.fused_iter_bytes_per_pair(3, 388, 584) == 15_408_256
    assert tbm.fused_iter_bytes_per_pair(3, 388, 584, robust=False) == 14 * 388 * 584 * 4
    us, by = tbm.roofline_bound_us(8 * 15_408_256,
                                   8 * 388 * 584 * tbm.fused_iter_flops_per_pixel(3),
                                   "NVIDIA H100 80GB HBM3")
    assert by == "bytes" and us == pytest.approx(36.7958, abs=1e-3)
    us, by = tbm.roofline_bound_us(1.0, 1e12, "NVIDIA H100 80GB HBM3")
    assert by == "operations" and us == pytest.approx(1e6 / 67.0)


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0),
                                       ("NVIDIA H100 NVL", 3900.0),
                                       ("NVIDIA H200", 4800.0),
                                       ("Tesla T4", None)])
def test_hbm_peak_gbs(name, peak):
    got, src = tbm.hbm_peak_gbs(name)
    assert got == peak
    assert ("unknown card" in src) == (peak is None)
    if peak is None:
        assert tbm.roofline_bound_us(1e9, 1e9, name) == (None, None)


@pytest.mark.parametrize("fn", [tbm.run_benchmark, tbm.kernel_roofline, tbm.vpu_floor,
                                tps.profile_stages, tps.profile_large_frame],
                         ids=lambda f: f.__name__)
def test_measurements_raise_without_a_card(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()


# ---- K5: the warp floor ----

def _keys(t):
    return [-0.5 * t ** 3 + t ** 2 - 0.5 * t, 1.5 * t ** 3 - 2.5 * t ** 2 + 1.0,
            -1.5 * t ** 3 + 2.0 * t ** 2 + 0.5 * t, 0.5 * t ** 3 - 0.5 * t ** 2]


@pytest.mark.parametrize("shape", [(2, 3, 21, 70), (1, 1, 4, 37)])
def test_warp_floor_ref_matches_jax_sampler(shape):
    """warp_floor_ref is JAX bicubic_sample on the static grid, and the
    definition sum_ij wy_i(fy) wx_j(fx) img[y+i, x+j] (float64 oracle)."""
    b, c, h, w = shape
    img = np.random.default_rng(11).uniform(0, 255, shape).astype(np.float32)
    got = k5.warp_floor_ref(torch.tensor(img))
    assert got.shape == (b, c, h - 3, w - 3)
    assert torch.equal(k5.warp_floor(torch.tensor(img)), got)      # CPU: the plain path
    gx, gy = k5.floor_grid(b, h - 3, w - 3)
    want = j_sample(jnp.asarray(img.transpose(0, 2, 3, 1)), jnp.asarray(gx.numpy()),
                    jnp.asarray(gy.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=WARP_ATOL)
    ys, xs = np.arange(h - 3), np.arange(w - 3)
    wy, wx = _keys((ys % 8) / 8.0), _keys((xs % 32) / 32.0)
    img64 = img.astype(np.float64)
    direct = sum(wy[i][:, None] * wx[j][None, :] * img64[:, :, i:i + h - 3, j:j + w - 3]
                 for i in range(4) for j in range(4))
    np.testing.assert_allclose(got.numpy(), direct, rtol=0, atol=WARP_ATOL)


def test_warp_floor_rejects_small_frames():
    with pytest.raises(ValueError):
        k5.warp_floor(torch.zeros(1, 3, 3, 40))


# ---- harness ----

@pytest.mark.parametrize("ttype", list(T), ids=lambda t: t.name)
def test_random_params_matches_jax(ttype):
    got = thv.random_params(4, ttype, 48, 64, magnitude=2.5, seed=9)
    want = jhv.random_params(4, jica.TransformType[ttype.name], 48, 64, magnitude=2.5, seed=9)
    np.testing.assert_array_equal(got, want)


def test_make_pairs_matches_jax(bank):
    ti1, ti2, tgt = thv.make_pairs(bank, T.AFFINITY, magnitude=2.0, seed=4, device="cpu")
    ji1, ji2, jgt = jhv.make_pairs(bank, jica.TransformType.AFFINITY, magnitude=2.0, seed=4)
    np.testing.assert_array_equal(tgt, jgt)
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(ti1.numpy(), np.asarray(ji1), rtol=0, atol=WARP_ATOL)


def test_make_occluded_pairs_matches_jax(bank):
    ti1, ti2, tgt, tmask = thv.make_occluded_pairs(bank, T.EUCLIDEAN, occl_frac=0.2,
                                                   seed=2, device="cpu")
    ji1, ji2, jgt, jmask = jhv.make_occluded_pairs(bank, jica.TransformType.EUCLIDEAN,
                                                   occl_frac=0.2, seed=2)
    np.testing.assert_array_equal(tgt, jgt)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(ti1.numpy(), np.asarray(ji1), rtol=0, atol=WARP_ATOL)


def test_evaluate_matches_jax(bank):
    """The port's evaluate against JAX evaluate on 4 pairs: the same
    converged and diverged fractions, and per pair (the align runs inside
    each evaluate, on each side's own pairs) corner error <= 1e-2 px."""
    cfg = tica.AlignConfig(transform=T.EUCLIDEAN, robust=tica.RobustLoss.CHARBONNIER,
                           nscales=2, delta=6)
    jcfg = jica.AlignConfig(transform=jica.TransformType.EUCLIDEAN,
                            robust=jica.RobustLoss.CHARBONNIER, nscales=2, delta=6,
                            use_pallas=False)
    got = thv.evaluate(bank, cfg, magnitude=2.0, seed=1, device="cpu")
    want = jhv.evaluate(bank, jcfg, magnitude=2.0, seed=1)
    assert (got.batch, got.transform, got.robust, got.nscales) == (
        want.batch, want.transform, want.robust, want.nscales)
    assert got.converged_frac == want.converged_frac == 1.0
    assert got.diverged_frac == want.diverged_frac
    assert got.seconds > 0 and got.pairs_per_sec > 0

    ti1, ti2, gt = thv.make_pairs(bank, T.EUCLIDEAN, magnitude=2.0, seed=1, device="cpu")
    ji1, ji2, _ = jhv.make_pairs(bank, jica.TransformType.EUCLIDEAN, magnitude=2.0, seed=1)
    tp = tica.align(ti1, ti2, cfg).p.numpy()
    jp = np.asarray(jica.align(ji1, ji2, jcfg).p)
    h, w = bank.shape[1:3]
    assert corner_err(tp, jp, T.EUCLIDEAN, h, w).max() <= CORNER_TOL
    assert corner_err(tp, gt, T.EUCLIDEAN, h, w).max() <= CORNER_TOL


def test_evaluate_needs_a_card_by_default(monkeypatch, bank):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thv.evaluate(bank, tica.AlignConfig(nscales=1))


def test_occlusion_sweep_separates_the_losses():
    """QUADRATIC degrades on occluded pairs while every robust loss holds
    (the JAX package's EVAL_r05.json finding), on 4 contents at 64x64."""
    images = np.stack(tre._procedural_textures(4, 64, seed=0))
    rows = thv.evaluate_occlusion(images, tica.AlignConfig(transform=T.EUCLIDEAN, nscales=2,
                                                           delta=6), device="cpu")
    mae = {r.robust: r.mae for r in rows}
    assert list(mae) == [r.name for r in tica.RobustLoss]
    assert all(v <= 1e-2 for k, v in mae.items() if k != "QUADRATIC")
    assert mae["QUADRATIC"] > 3 * max(v for k, v in mae.items() if k != "QUADRATIC")


# ---- eval bank ----

def test_procedural_textures_match_jax():
    got = tre._procedural_textures(5, 40, seed=0)
    want = jre._procedural_textures(5, 40, seed=0)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (40, 40, 3)
        np.testing.assert_allclose(g, w, rtol=0, atol=TEXTURE_ATOL)


def test_eval_banks_without_the_reference(monkeypatch):
    monkeypatch.delenv(tbm.REFERENCE_DIR_ENV, raising=False)
    assert tre._reference_crops(32) == []
    bank = tre.load_eval_images(batch=3, size=32)
    np.testing.assert_allclose(bank, np.stack(jre.load_eval_images(batch=3, size=32)),
                               rtol=0, atol=TEXTURE_ATOL)
    legacy = tre.legacy_eval_images(batch=3, size=32)
    assert legacy.shape == (3, 32, 32, 3) and np.array_equal(legacy[0], legacy[2])
