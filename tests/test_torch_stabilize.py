"""examples/stabilize_torch.py (the port's video-stabilization walkthrough)
vs examples/stabilize.py (the JAX package's), on the CPU.

Both build the same 8-frame euclidean jitter sequence at 288x384 from the
synthetic scene (the same numpy draws, seed and blur; the reference's
image is kept out on both sides so that they see the same scene) and
register it to frame 0 in one batched `align`. The port's per-frame
parameters must lie within 1e-2 px of corner displacement of the JAX
script's and of the ground-truth jitter (float32 solves whose sums run in
another order).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as jica
from inverse_compositional_algorithm_tpu.ops.transforms import pad_params, transform_points
from inverse_compositional_algorithm_tpu.utils import imageio as jio
from inverse_compositional_algorithm_tpu_torch.eval.benchmarks import REFERENCE_DIR_ENV

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNER_TOL = 1e-2
H, W = 288, 384


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corner_err(pa, pb):
    t = jica.TransformType.EUCLIDEAN
    xs = jnp.asarray([0.0, W - 1.0, 0.0, W - 1.0], jnp.float64)
    ys = jnp.asarray([0.0, 0.0, H - 1.0, H - 1.0], jnp.float64)
    ax, ay = transform_points(pad_params(jnp.asarray(pa, jnp.float64), t), t, xs, ys)
    bx, by = transform_points(pad_params(jnp.asarray(pb, jnp.float64), t), t, xs, ys)
    return np.asarray(jnp.max(jnp.hypot(ax - bx, ay - by), axis=-1))


def _no_reference(*args, **kwargs):
    raise FileNotFoundError("the reference's image is kept out of this test")


def test_stabilize_torch_matches_jax_walkthrough(monkeypatch):
    monkeypatch.setattr(jio, "load_image", _no_reference)
    monkeypatch.delenv(REFERENCE_DIR_ENV, raising=False)
    jstab, tstab = _load("stabilize"), _load("stabilize_torch")

    frames, gt = jstab.make_sequence()
    cfg = jica.AlignConfig(transform=jica.TransformType.EUCLIDEAN, nscales=3)
    want = np.asarray(jica.align(frames, jnp.broadcast_to(frames[:1], frames.shape),
                                 cfg).params(cfg), np.float64)
    got = tstab.main(device="cpu")
    assert got.shape == (8, 3) and np.isfinite(got).all()
    assert corner_err(got, want).max() <= CORNER_TOL
    assert corner_err(got, gt[:, :3]).max() <= CORNER_TOL


def test_stabilize_torch_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("stabilize_torch").main()
