"""Video-stabilization walkthrough on the PyTorch/CUDA port: batched
frame-to-keyframe registration.

The twin of examples/stabilize.py (the JAX package's walkthrough) on
`inverse_compositional_algorithm_tpu_torch.align`: a jittered sequence of
8 frames at 288x384 (a few px of translation and about 0.5 degree of
roll, euclidean) is registered to its first frame in ONE batched `align`
call, every pair converging on its own, then re-rendered through the
estimated warps. The scene is the reference's rubber_whale.png when the
ICA_REFERENCE_DIR environment variable names a checkout of the reference,
else the JAX script's synthetic texture (the same seed and blur). It
imports nothing of JAX.

Run:  python examples/stabilize_torch.py [outdir] [--device cpu]
      (CUDA by default; saving frames to outdir needs PIL)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import inverse_compositional_algorithm_tpu_torch as ica  # noqa: E402
from inverse_compositional_algorithm_tpu_torch.eval.benchmarks import (  # noqa: E402
    REFERENCE_DIR_ENV,
)
from inverse_compositional_algorithm_tpu_torch.models.api import default_device  # noqa: E402
from inverse_compositional_algorithm_tpu_torch.ops.pyramid import gaussian_blur  # noqa: E402
from inverse_compositional_algorithm_tpu_torch.ops.transforms import (  # noqa: E402
    pad_params,
    transform_grid,
)
from inverse_compositional_algorithm_tpu_torch.ops.warp import bicubic_sample  # noqa: E402


def load_scene(h: int, w: int, device) -> torch.Tensor:
    """[1, h, w, 3]: the centre of the reference's rubber_whale.png (a real
    Middlebury frame) when REFERENCE_DIR_ENV names the reference's checkout,
    else a synthetic smooth texture (the JAX script's draws)."""
    ref = os.environ.get(REFERENCE_DIR_ENV)
    path = os.path.join(ref, "test", "data", "rubber_whale.png") if ref else None
    if path and os.path.isfile(path):
        from inverse_compositional_algorithm_tpu_torch.utils.imageio import load_image

        img = load_image(path)
        y0, x0 = (img.shape[0] - h) // 2, (img.shape[1] - w) // 2
        if y0 >= 0 and x0 >= 0:
            print("scene: Middlebury rubber_whale (real image)")
            return torch.tensor(img[None, y0:y0 + h, x0:x0 + w, :3], device=device)
    rng = np.random.default_rng(42)
    print("scene: synthetic texture (reference data not found)")
    noise = torch.tensor(rng.uniform(0, 255, (1, h, w, 3)), dtype=torch.float32, device=device)
    return gaussian_blur(noise, 2.0)


def make_sequence(n_frames: int = 8, h: int = 288, w: int = 384, seed: int = 0,
                  device=None):
    """(frames [n, h, w, 3] on `device`, jitter [n, 8] numpy): the scene
    observed through a jittering euclidean camera, frame 0 unmoved."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    scene = load_scene(h, w, dev)
    jitter = np.zeros((n_frames, 8), np.float32)
    jitter[1:, 0] = rng.uniform(-4, 4, n_frames - 1)
    jitter[1:, 1] = rng.uniform(-4, 4, n_frames - 1)
    jitter[1:, 2] = rng.uniform(-0.01, 0.01, n_frames - 1)
    t = ica.TransformType.EUCLIDEAN
    gx, gy = transform_grid(pad_params(torch.tensor(jitter, device=dev), t), t, h, w)
    return bicubic_sample(scene.expand(n_frames, h, w, 3), gx, gy), jitter


def main(outdir: str | None = None, device=None) -> np.ndarray:
    """Register the sequence to frame 0; print and return the per-frame
    [tx, ty, theta] estimates ([n, 3] numpy)."""
    frames, gt = make_sequence(device=device)
    n = frames.shape[0]
    print(f"device: {frames.device}, frames: {tuple(frames.shape)}")

    # Register every frame to the keyframe (frame 0) in one batched call.
    cfg = ica.AlignConfig(transform=ica.TransformType.EUCLIDEAN, nscales=3)
    key = frames[:1].expand(frames.shape).contiguous()
    res = ica.align(frames, key, cfg)   # warp(frame_k) onto keyframe

    est = res.params(cfg).cpu().numpy()
    print("per-frame estimated [tx ty theta] vs ground-truth jitter:")
    for k in range(n):
        print(f"  frame {k}: est {np.round(est[k], 4)}  gt {gt[k, :3]}"
              f"  iters={int(res.niters[k])}  diverged={bool(res.diverged[k])}")
    print(f"max parameter error: {np.abs(est - gt[:, :3]).max():.2e}")

    # Stabilized sequence = each frame warped back onto the keyframe grid.
    stabilized = res.iw.cpu().numpy()
    residual = np.nanmean(np.abs(res.di.cpu().numpy()), axis=(1, 2, 3))
    print("mean |frame - keyframe| after stabilization (0..255 scale):",
          [f"{v:.2e}" for v in residual])

    if outdir:
        from inverse_compositional_algorithm_tpu_torch.utils.imageio import save_image

        os.makedirs(outdir, exist_ok=True)
        for k in range(n):
            save_image(stabilized[k], os.path.join(outdir, f"stab_{k:03d}.png"))
        # side-by-side evidence strip: jittered input row over stabilized row
        raw = frames.cpu().numpy()
        strip = np.concatenate([
            np.concatenate(list(raw[: min(4, n)]), axis=1),
            np.concatenate(list(np.nan_to_num(stabilized[: min(4, n)])), axis=1),
        ], axis=0)
        save_image(strip, os.path.join(outdir, "strip.png"))
        print(f"wrote {n} stabilized frames + strip.png to {outdir}/")
    return est


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.outdir, args.device)
