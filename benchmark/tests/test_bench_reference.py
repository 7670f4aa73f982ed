"""The plain reference against the program's CPU path at tiny sizes, for
both configurations: in float64 the two are the same algorithm to rounding
(1e-6 px: at 72x96 a hard pair's coarse levels are ill-conditioned and
amplify float64 rounding to ~1e-7 px); the program in float32 lands within
a small fraction of a pixel."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import inverse_compositional_algorithm_tpu_torch as port
from benchmark import harness
from benchmark.reference import align_ref as R
from benchmark.traffic.generate import load_mix, make_pool

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ["homography_charbonnier", "euclidean_quadratic"]


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def pairs(transform, kind, seed, hard_share=0.25):
    name = "bulk_b1024_584x388" if kind == "bulk" else "clip_b64_1080p"
    mix = dict(load_mix(name), batch=6, height=72, width=96, pool=1, hard_share=hard_share,
               render_chunk=6, margin_px=24 if kind == "bulk" else 200)
    if kind == "clip":
        mix["hard"] = {"translation_px": 6.0, "linear_over_l": 12.0}
    return make_pool(mix, transform, seed, "cpu")[0]


def nearest(ref, p, t, h, w):
    """Per pair: the reference row nearest the program's p, and the gap."""
    gap = R.corner_gap_px(p[ref.pair], ref.p, t, h, w)
    best = torch.full((p.shape[0],), float("inf"), dtype=torch.float64)
    rows = torch.zeros(p.shape[0], dtype=torch.long)
    for r in range(len(gap)):
        if gap[r] < best[ref.pair[r]]:
            best[ref.pair[r]], rows[ref.pair[r]] = gap[r], r
    return rows, best


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kind", ["bulk", "clip"])
def test_float64_program_is_the_reference(name, kind):
    cfg = config(name)
    b = pairs(cfg["transform"], kind, 21)
    res = port.align(b.i1, b.i2, harness.align_config(port, cfg), dtype=torch.float64)
    ref = R.align_ref(b.i1, b.i2, cfg)
    rows, gap = nearest(ref, res.p, cfg["transform"], 72, 96)
    assert float(gap.max()) < 1e-6
    assert torch.equal(res.diverged, ref.diverged[rows])
    assert torch.equal(res.valid, ref.valid[rows])
    v = res.valid[..., None].expand_as(res.iw)
    assert float((res.iw - ref.iw[rows])[v].abs().max()) < 1e-5
    assert float((res.di - ref.di[rows])[v].abs().max()) < 1e-5
    assert torch.isnan(ref.iw[rows][~v]).all() and torch.isnan(res.iw[~v]).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_float32_program_is_near_the_reference(name):
    cfg = config(name)
    b = pairs(cfg["transform"], "bulk", 5, hard_share=0.0)
    res = port.align(b.i1, b.i2, harness.align_config(port, cfg))
    ref = R.align_ref(b.i1, b.i2, cfg)
    _, gap = nearest(ref, res.p.double(), cfg["transform"], 72, 96)
    assert float(gap.max()) < 1e-2


def test_forks_keep_both_answers_near_tol():
    """A pair whose ||dp|| lands within fork_rel of tol gets a second row
    that took the other decision; with fork_rel = 0 none does."""
    cfg = dict(config("homography_charbonnier"), max_iter=30)
    b = pairs("HOMOGRAPHY", "bulk", 21)
    wide = R.align_ref(b.i1, b.i2, cfg, fork_rel=0.5, warp=False)
    none = R.align_ref(b.i1, b.i2, cfg, fork_rel=0.0, warp=False)
    assert len(none.pair) == 6 and len(wide.pair) > 6
    np.testing.assert_array_equal(np.bincount(wide.pair.numpy()) >= 1, True)
    np.testing.assert_allclose(wide.p[:6].numpy(), none.p.numpy(), rtol=1e-9, atol=1e-12)


def test_corner_gap():
    p = torch.zeros(2, 8, dtype=torch.float64)
    q = p.clone()
    q[1, 2] = 0.5
    np.testing.assert_allclose(R.corner_gap_px(p, q, "HOMOGRAPHY", 10, 20).numpy(), [0.0, 0.5])
    q[1, 6] = 0.05   # projective: the far corners move most
    assert float(R.corner_gap_px(p, q, "HOMOGRAPHY", 10, 20)[1]) > 0.5
