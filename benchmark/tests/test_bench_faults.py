"""The whole run, without the look for a card, at a tiny size on the CPU:
sound, it comes out correct; with the timed path broken underneath, in
each way a cell of this benchmark can break, `correct` comes out false.
The cells run on one card each, so no exchange between cards exists to
leave out."""

import time

import pytest
import torch

import inverse_compositional_algorithm_tpu_torch as port
from benchmark import harness, run as bench_run
from inverse_compositional_algorithm_tpu_torch.models import api, pyramidal

CELLS = {"HOMOGRAPHY": "homography_charbonnier.bulk_b1024_584x388",
         "EUCLIDEAN": "euclidean_quadratic.clip_b64_1080p"}


def tiny_run(name):
    cell = harness.load_cell(name)
    cell.mix = dict(cell.mix, batch=4, height=56, width=72, pool=2, check_pairs=2,
                    hard_share=0.0, render_chunk=4,
                    margin_px=160 if cell.mix["kind"] == "clip" else 16)
    return harness.Run(cell=cell, seed=2 ** 31 + 99, seconds=0.0, device=torch.device("cpu"),
                       system=port.align, port=port, cfg=harness.align_config(port, cell.config),
                       t0=time.perf_counter())


def execute(run):
    run.seconds = 6.0
    return bench_run.execute(run, trace=False)


def state_unchanged(*a, **k):
    """Every level returns the warm start as it came in."""
    state = real_ic_solve(*a, **k)
    state.p = a[2].clone()
    return state


def half_batch(i1, i2, p0, *a, **k):
    """Solve the first half of the pairs; the rest get their mean."""
    h = i1.shape[0] // 2
    state, per = real_pyramidal(i1[:h], i2[:h], p0[:h], *a, **k)
    fill = state.p.mean(0, keepdim=True).expand(i1.shape[0] - h, -1)
    for f in ("error", "niters", "diverged"):
        v = getattr(state, f)
        setattr(state, f, torch.cat([v, v[:1].expand(i1.shape[0] - h)]))
    state.p = torch.cat([state.p, fill])
    return state, per


def altered_answer(i1, i2, p0, cfg):
    """One pair's answer moved by 0.25 px where it is produced."""
    res = real_align_impl(i1, i2, p0, cfg)
    slot = 2 if cfg.transform is port.TransformType.HOMOGRAPHY else 0
    res.p = res.p.clone()
    res.p[1, slot] += 0.25
    return res


def tf32_on(i1, i2, p0, cfg):
    """TF32 switched on for the program's float32 products, against the
    configuration's `tf32: false`."""
    torch.backends.cuda.matmul.allow_tf32 = True
    return real_align_impl(i1, i2, p0, cfg)


def altered_warp(image, img_p, gx, gy, delta):
    """One pair's final warp off by half a grey level where K3 produces it."""
    iw, valid = real_warp(image, img_p, gx, gy, delta)
    iw = iw.clone()
    iw[1] += 0.5
    return iw, valid


def lost_mask(image, img_p, gx, gy, delta):
    """The final warp's valid mask lost: every pixel out of the domain."""
    iw, valid = real_warp(image, img_p, gx, gy, delta)
    return iw, torch.zeros_like(valid)


real_warp = api.warp_image_fast
real_ic_solve = pyramidal.ic_solve
real_pyramidal = api.pyramidal_solve
real_align_impl = api._align_impl


@pytest.mark.parametrize("transform", sorted(CELLS))
def test_sound_run_is_correct(transform):
    line = execute(tiny_run(CELLS[transform]))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 8 and line["failed"] == 0
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("transform", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer",
                                   "altered_warp", "lost_mask", "tf32_on"])
def test_fault_is_not_correct(transform, fault, monkeypatch):
    target = {"state_unchanged": (pyramidal, "ic_solve", state_unchanged),
              "half_batch": (api, "pyramidal_solve", half_batch),
              "altered_answer": (api, "_align_impl", altered_answer),
              "altered_warp": (api, "warp_image_fast", altered_warp),
              "lost_mask": (api, "warp_image_fast", lost_mask),
              "tf32_on": (api, "_align_impl", tf32_on)}[fault]
    monkeypatch.setattr(*target)
    try:
        line = execute(tiny_run(CELLS[transform]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not line["correct"], line["checks"]
