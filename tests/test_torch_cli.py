"""The port's CLI, image IO, validation, profiling and plots against the
JAX package's twins, on the CPU (`--device cpu`) at small sizes.

`align` on both CLIs reads the same PNG pair and must give parameters
within 1e-2 px of corner displacement (the cross-implementation bar of
test_torch_align.py); the other commands and helpers must give the same
files and values.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as jica
from inverse_compositional_algorithm_tpu import cli as jcli
from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur
from inverse_compositional_algorithm_tpu.ops.transforms import (
    pad_params, transform_grid, transform_points,
)
from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample
from inverse_compositional_algorithm_tpu.utils import imageio as jio
from inverse_compositional_algorithm_tpu_torch import cli as tcli
from inverse_compositional_algorithm_tpu_torch import config as tconfig
from inverse_compositional_algorithm_tpu_torch.models.api import align as ica_align
from inverse_compositional_algorithm_tpu_torch.eval.plots import plot_record
from inverse_compositional_algorithm_tpu_torch.utils import imageio as tio
from inverse_compositional_algorithm_tpu_torch.utils.profiling import trace
from inverse_compositional_algorithm_tpu_torch.utils.validation import valid_values

torch.set_num_threads(1)

H, W = 64, 80
CORNER_TOL = 1e-2


@pytest.fixture(scope="module")
def png_pair(tmp_path_factory):
    """(I1.png, I2.png) of a smooth image and its copy moved by a known
    motion, one file per (transform, p). Each file is min/max normalized to
    8 bits on its own, so the pair's exact solution is near p, not p."""
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    img = gaussian_blur(jnp.asarray(rng.uniform(0, 255, (1, H, W, 3)), jnp.float32), 2.5)

    def make(ttype_name, p):
        ttype = jica.TransformType[ttype_name]
        gx, gy = transform_grid(pad_params(jnp.asarray([p], jnp.float32)), ttype, H, W)
        paths = (str(d / f"{ttype_name}_1.png"), str(d / f"{ttype_name}_2.png"))
        jio.save_image(np.asarray(bicubic_sample(img, gx, gy))[0], paths[0])
        jio.save_image(np.asarray(img)[0], paths[1])
        return paths

    return make


def corner_err(pa, pb, ttype_name):
    ttype = jica.TransformType[ttype_name]
    xs = jnp.asarray([0.0, W - 1.0, 0.0, W - 1.0], jnp.float64)
    ys = jnp.asarray([0.0, 0.0, H - 1.0, H - 1.0], jnp.float64)
    ax, ay = transform_points(pad_params(jnp.asarray(pa, jnp.float64), ttype), ttype, xs, ys)
    bx, by = transform_points(pad_params(jnp.asarray(pb, jnp.float64), ttype), ttype, xs, ys)
    return float(jnp.max(jnp.hypot(ax - bx, ay - by)))


@pytest.mark.parametrize("ttype,p", [("TRANSLATION", [2.0, -1.0]),
                                     ("EUCLIDEAN", [1.5, 1.0, 0.02])])
def test_cli_align_matches_jax(tmp_path, png_pair, ttype, p):
    i1, i2 = png_pair(ttype, p)
    args = ["align", i1, i2, "--transform", ttype.lower(), "--nscales", "2",
            "--delta", "6", "--robust", "charbonnier"]
    t_out, j_out = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    warped = str(tmp_path / "w.png")
    assert tcli.main(args + ["--output", t_out, "--device", "cpu",
                             "--save-warped", warped, "--save-error",
                             str(tmp_path / "e.png")]) == 0
    assert jcli.main(args + ["--output", j_out]) == 0
    with open(t_out) as f:
        got = json.load(f)
    with open(j_out) as f:
        want = json.load(f)
    assert got["device"] == "cpu"
    for key in ("transform", "robust", "nscales", "diverged"):
        assert got[key] == want[key]
    assert len(got["p"]) == len(want["p"]) == jica.nparams(jica.TransformType[ttype])
    assert corner_err(got["p"], want["p"], ttype) <= CORNER_TOL
    assert abs(got["iterations"] - want["iterations"]) <= 1
    assert tio.load_image(warped).shape == (H, W, 3)


def test_cli_align_needs_a_card_by_default(monkeypatch, png_pair):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    i1, i2 = png_pair("TRANSLATION", [2.0, -1.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["align", i1, i2, "--nscales", "1"])


def test_cli_make_config_matches_jax(tmp_path):
    t_path, j_path = str(tmp_path / "t.ini"), str(tmp_path / "j.ini")
    assert tcli.main(["make-config", t_path]) == 0
    assert jcli.main(["make-config", j_path]) == 0
    with open(t_path) as f, open(j_path) as g:
        assert f.read() == g.read()
    got = tconfig.read_config_file(t_path)
    want = jica.read_config_file(j_path)
    assert got == {k: tconfig.config_from_jax(v) for k, v in want.items()}


def test_cli_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["bench", "--batch", "1"])


def test_plot_record_writes_files(tmp_path):
    row = dict(transform="EUCLIDEAN", robust="CHARBONNIER", nscales=3,
               batch=2, mse=1e-8, mae=1e-4, max_err=3e-4, pairs_per_sec=10.0,
               seconds=0.2, mean_iters=3.0, converged_frac=1.0, diverged_frac=0.0)
    rec = {"device": "test", "sweeps": {
        "transforms": [row, {**row, "transform": "AFFINITY"}],
        "robust_losses": [row],
        "pyramid_levels": [row, {**row, "nscales": 5}],
    }}
    paths = plot_record(rec, str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [
        "transforms.png", "robust_losses.png", "pyramid_levels.png"]
    assert all(os.path.getsize(p) > 1000 for p in paths)


def test_imageio_matches_jax(tmp_path):
    img = np.random.default_rng(1).uniform(-20, 300, (9, 13, 3))
    img[2, 3, 1] = np.nan
    np.testing.assert_array_equal(tio.to_uint8(img), jio.to_uint8(img))
    np.testing.assert_array_equal(tio.to_uint8(torch.tensor(img)), jio.to_uint8(img))
    path = str(tmp_path / "x.png")
    tio.save_image(torch.tensor(img), path)
    back = tio.load_image(path)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, jio.load_image(path))
    np.testing.assert_array_equal(back, tio.to_uint8(img).astype(np.float32))


def test_valid_values():
    assert valid_values(np.ones(3)) and valid_values(torch.ones(3))
    assert not valid_values(np.array([1.0, np.inf]))
    assert not valid_values(torch.tensor([np.nan, 1.0]))


def test_stage_timer_and_trace(tmp_path):
    """`trace()` writes a Chrome trace of a call with the program's stage
    spans (`ica.*`) and yields the profiler with the per-op sums."""
    rng = np.random.default_rng(3)
    img = torch.tensor(rng.uniform(0, 255, (1, 32, 40, 3)), dtype=torch.float32)
    cfg = tconfig.AlignConfig(nscales=2, delta=2)
    with trace(str(tmp_path)) as prof:
        ica_align(img, torch.roll(img, 1, dims=2), cfg)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ica.align", "ica.pyramid", "ica.level", "ica.level.setup", "ica.trip",
            "ica.trip.system", "ica.trip.update", "ica.trip.sync", "ica.final_warp"} <= names
    assert any(e.key == "aten::mul" for e in prof.key_averages())