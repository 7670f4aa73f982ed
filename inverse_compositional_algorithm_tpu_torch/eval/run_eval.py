"""Run the evaluation sweeps and record them as JSON.

The port's counterpart of the JAX package's eval/run_eval.py, which mirrors
the reference's recorded notebook sweeps
(test/ica_keras_performance_tests_colab.ipynb cells 18/24/29): transform
sweep, robust-loss sweep, pyramid-depth sweep, a large-motion stress sweep,
an occlusion sweep and the 8-image continuity lane, each with accuracy
(parameter-space MSE/MAE/max), converged fraction and throughput.

Run:  python -m inverse_compositional_algorithm_tpu_torch.eval.run_eval [out.json] [--device cpu]

Image set: distinct crops and scales of the reference's Middlebury images
when `ICA_REFERENCE_DIR` names a checkout of the reference (its test/data),
then procedural textures with a range of spectra (band-pass filtered noise
at varied cutoffs and multi-scale mixtures), 64 distinct 256x256 contents
per sweep, the same numpy draws as the JAX package. Periodic patterns are
excluded: their translation ambiguity would make parameter-space error
meaningless.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import AlignConfig
from ..models.api import default_device
from ..ops.normal_equations import RobustLoss
from ..ops.pyramid import gaussian_blur, zoom_out
from ..ops.transforms import TransformType
from .benchmarks import REFERENCE_DIR_ENV, card_info
from .harness import (
    evaluate_occlusion,
    evaluate_pyramid_levels,
    evaluate_robust_losses,
    evaluate_transforms,
)

__all__ = ["load_eval_images", "legacy_eval_images", "main"]

REF_IMAGES = ("rubber_whale.png", "dimetrodon.png", "hydrangea.png",
              "lena_color.tiff", "mandrill.tiff", "peppers3.tif")


def _reference_images(size: int):
    """Yield each reference image ([H, W, 3] float32) at least `size`
    square; none when REFERENCE_DIR_ENV is unset or names no checkout."""
    ref = os.environ.get(REFERENCE_DIR_ENV)
    if not ref:
        return
    from ..utils.imageio import load_image

    for name in REF_IMAGES:
        path = os.path.join(ref, "test", "data", name)
        if not os.path.isfile(path):
            continue
        img = np.asarray(load_image(path), np.float32)
        if img.ndim == 3 and img.shape[0] >= size and img.shape[1] >= size:
            yield img


def _reference_crops(size: int) -> list:
    """Distinct crops/scales of every available reference image."""
    imgs = []
    for img in _reference_images(size):
        h, w = img.shape[:2]
        # five native-scale crops: corners + center
        for (y0, x0) in ((0, 0), (0, w - size), (h - size, 0),
                         (h - size, w - size), ((h - size) // 2, (w - size) // 2)):
            imgs.append(img[y0:y0 + size, x0:x0 + size, :3])
        # two downscaled variants: the whole frame shrunk so `size` covers
        # more scene
        for nu in (0.66, 0.5):
            small = zoom_out(torch.from_numpy(img[None]), nu)[0].numpy()
            sh, sw = small.shape[:2]
            if sh >= size and sw >= size:
                y0, x0 = (sh - size) // 2, (sw - size) // 2
                imgs.append(small[y0:y0 + size, x0:x0 + size, :3].astype(np.float32))
    return imgs


def _blur(a: np.ndarray, sigma: float) -> np.ndarray:
    """Blur in float64: the saturation-clipped textures amplify the blur's
    rounding ~1000x, and float64 keeps that under 1e-3 of 255."""
    return gaussian_blur(torch.from_numpy(a).double(), sigma)[0].numpy()


def _procedural_textures(n: int, size: int, seed: int = 0,
                         hostile_frac: float = 0.25) -> list:
    """n distinct aperiodic textures with varied spectra: per-texture random
    blur cutoff (band limit), optional multi-scale mixture, random contrast.
    All are well-posed for alignment (no translation ambiguity).

    A `hostile_frac` share of the bank is made deliberately HOSTILE to
    gradient-based alignment: flat/low-texture patches covering ~25-40% of
    the frame (zero gradient there) and saturation-clipped contrast (values
    crushed to 0/255 plateaus)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        noise = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
        sigma = float(rng.uniform(1.0, 8.0))
        tex = _blur(noise, sigma)
        if rng.random() < 0.5:   # add a fine-detail layer
            fine = _blur(rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32), 1.0)
            tex = 0.7 * tex + 0.3 * fine
        tex = tex - tex.min()
        tex = tex / max(tex.max(), 1e-6)
        hostile = i % max(1, int(round(1.0 / max(hostile_frac, 1e-6)))) == 0
        if hostile and rng.random() < 0.5:
            # flat patch: a featureless region of ~25-40% of the area
            side = int(size * rng.uniform(0.5, 0.63))
            y0 = int(rng.integers(0, size - side + 1))
            x0 = int(rng.integers(0, size - side + 1))
            tex[y0:y0 + side, x0:x0 + side] = float(rng.uniform(0.3, 0.7))
            tex = tex * float(rng.uniform(150.0, 255.0))
        elif hostile:
            # saturation clipping: crush ~40% of pixels into 0/255 plateaus
            tex = np.clip((tex - 0.5) * float(rng.uniform(2.5, 4.0)) + 0.5,
                          0.0, 1.0) * 255.0
        else:
            tex = tex * float(rng.uniform(150.0, 255.0))
        out.append(tex.astype(np.float32))
    return out


def load_eval_images(batch: int = 64, size: int = 256) -> np.ndarray:
    """[batch, size, size, 3] float32 eval stack of DISTINCT contents:
    reference crops/scales first, procedural textures for the remainder."""
    imgs = _reference_crops(size)[:batch]
    if len(imgs) < batch:
        imgs += _procedural_textures(batch - len(imgs), size, seed=0)
    return np.stack(imgs[:batch])


def legacy_eval_images(batch: int = 8, size: int = 256) -> np.ndarray:
    """The JAX package's round-3 continuity stack: center crops of the
    reference images replicated to `batch` (a procedural texture without
    the checkout)."""
    imgs = []
    for img in _reference_images(size):
        y0 = (img.shape[0] - size) // 2
        x0 = (img.shape[1] - size) // 2
        imgs.append(img[y0:y0 + size, x0:x0 + size, :3])
    if not imgs:
        imgs = _procedural_textures(1, size, seed=0)
    return np.stack([imgs[i % len(imgs)] for i in range(batch)])


def main(out_path: str | None = None, device=None) -> dict:
    """Run every sweep on `device` (CUDA by default) and write the record."""
    dev = default_device(device)
    images = load_eval_images()
    base = AlignConfig(transform=TransformType.EUCLIDEAN,
                       robust=RobustLoss.CHARBONNIER, nscales=3)

    card = card_info() if dev.type == "cuda" else None
    record = {
        "device": card["name"].replace(" ", "_") if card else str(dev),
        "card": card,
        "images": list(images.shape),
        "distinct_contents": int(images.shape[0]),
        "magnitude_px": 3.0,
        "sweeps": {},
    }

    def rows(results):
        return [dataclasses.asdict(r) for r in results]

    sweeps = record["sweeps"]
    print("transform sweep (5 models)...", flush=True)
    sweeps["transforms"] = rows(evaluate_transforms(images, base, device=dev))
    print("robust-loss sweep (5 losses)...", flush=True)
    sweeps["robust_losses"] = rows(evaluate_robust_losses(images, base, device=dev))
    print("pyramid-depth sweep (3/4/5)...", flush=True)
    sweeps["pyramid_levels"] = rows(evaluate_pyramid_levels(images, base, device=dev))
    # ~10 px of border displacement with the full 5-scale pyramid: the
    # large-random-motion regime where the reference's recorded eval
    # (colab cell 18) reports many non-converged pairs.
    print("large-motion stress sweep (magnitude 10, 5 scales)...", flush=True)
    sweeps["transforms_large_motion"] = rows(evaluate_transforms(
        images, base.replace(nscales=5), magnitude=10.0, device=dev))
    # A ~20%-area patch of each moving image belongs to another motion
    # layer: quadratic is expected to degrade while the robust losses hold.
    print("occlusion sweep (QUADRATIC vs robust, 20% second layer)...", flush=True)
    sweeps["occlusion_robustness"] = rows(evaluate_occlusion(
        images, base, occl_frac=0.2, device=dev))
    print("legacy 8-image continuity sweep...", flush=True)
    sweeps["transforms_legacy8"] = rows(evaluate_transforms(
        legacy_eval_images(), base, device=dev))

    if out_path:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {out_path}", flush=True)
    for sweep, rs in sweeps.items():
        for r in rs:
            print(f"{sweep:16s} {r['transform']:12s} {r['robust']:20s} "
                  f"ns={r['nscales']} mae={r['mae']:.2e} "
                  f"max={r['max_err']:.2e} conv={r['converged_frac']:.2f} "
                  f"{r['pairs_per_sec']:.1f} pairs/s", flush=True)
    return record


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("output", nargs="?", help="write the sweep record JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.output, args.device)
