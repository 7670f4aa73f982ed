"""Random-transform evaluation harness.

The port's counterpart of the JAX package's eval/harness.py (itself the
reference's `TFDSEvaluator`, test/ica_keras_performance_tests_colab.ipynb
cell 13): generate random ground-truth motions per model class, warp a base
image set, run the aligner, and report parameter-space MSE / MAE plus wall
time, with sweeps over transform type, robust loss and pyramid depth
(cells 18/24/29).

As in the JAX harness, the whole batch is one batched call with per-pair
convergence, and the metrics are taken against the ground truth itself
(I1 = I2 sampled at x'(x; gt), so the solver's fixed point is gt). The
pairs are made on `device`, CUDA unless the caller passes another one.
`seconds` is the wall time of the accuracy run itself (host clock, ending
in torch.cuda.synchronize on CUDA, the kernels' library already loaded),
where the JAX harness ran a separate two-point scan.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import AlignConfig
from ..models.api import _align_impl, default_device
from ..ops.kernels import _build
from ..ops.normal_equations import RobustLoss
from ..ops.transforms import TransformType, nparams, pad_params, transform_grid
from ..ops.warp import bicubic_sample

__all__ = ["EvalResult", "random_params", "make_pairs",
           "make_occluded_pairs", "evaluate", "evaluate_transforms",
           "evaluate_robust_losses", "evaluate_pyramid_levels",
           "evaluate_occlusion"]


@dataclass
class EvalResult:
    transform: str
    robust: str
    nscales: int
    batch: int
    mse: float           # parameter-space MSE vs ground truth
    mae: float           # parameter-space MAE
    max_err: float
    pairs_per_sec: float
    seconds: float
    mean_iters: float
    converged_frac: float
    diverged_frac: float  # pairs the finest-scale divergence guard tripped


def random_params(batch: int, ttype: TransformType, height: int, width: int,
                  magnitude: float = 3.0, seed: int = 0) -> np.ndarray:
    """[B, 8] random motions with ~`magnitude` pixels of border displacement
    (the reference draws uniform random transforms per class, colab cell 13)."""
    rng = np.random.default_rng(seed)
    l = max(height, width)
    p = np.zeros((batch, 8), np.float32)
    if ttype is TransformType.HOMOGRAPHY:
        p[:, [2, 5]] = rng.uniform(-magnitude, magnitude, (batch, 2))
        p[:, [0, 1, 3, 4]] = rng.uniform(-magnitude / l, magnitude / l, (batch, 4))
        p[:, 6:8] = rng.uniform(-magnitude / (l * l), magnitude / (l * l), (batch, 2))
    else:
        p[:, :2] = rng.uniform(-magnitude, magnitude, (batch, 2))
        k = nparams(ttype) - 2
        if k:
            p[:, 2:2 + k] = rng.uniform(-magnitude / l, magnitude / l, (batch, k))
    return p


def _warped(imgs: torch.Tensor, ttype: TransformType, gt: np.ndarray) -> torch.Tensor:
    _, h, w, _ = imgs.shape
    gx, gy = transform_grid(pad_params(torch.tensor(gt, device=imgs.device)), ttype, h, w)
    return bicubic_sample(imgs, gx, gy)


def make_pairs(images, ttype: TransformType, magnitude: float = 3.0, seed: int = 0,
               device=None):
    """images [B, H, W, C] -> (I1, I2, gt) with I1, I2 float32 tensors on
    `device` (CUDA by default) and gt [B, 8] numpy, where I1 = images
    sampled at x'(x; gt): the solver's exact fixed point is gt."""
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                           device=default_device(device))
    b, h, w, _ = imgs.shape
    gt = random_params(b, ttype, h, w, magnitude, seed)
    return _warped(imgs, ttype, gt), imgs, gt


def make_occluded_pairs(images, ttype: TransformType, magnitude: float = 3.0,
                        occl_frac: float = 0.2, seed: int = 0, device=None):
    """Pairs where a patch of the moving image belongs to a DIFFERENT
    motion layer, the predominant-motion workload IRLS exists for.

    I1 = warp(images, gt) as in `make_pairs`; then a random square patch
    covering `occl_frac` of I2's area is replaced with unrelated content
    (the next image in the bank). Those pixels violate the global motion
    model: a quadratic loss lets their large residuals pull the estimate
    away from gt, a redescending rho' down-weights them (reference IPOL
    2018.222).

    Returns (i1, i2_occluded, gt, occl_mask [B, H, W] bool numpy).
    """
    host = np.asarray(images, np.float32)
    dev = default_device(device)
    b, h, w, _ = host.shape
    rng = np.random.default_rng(seed + 1)
    gt = random_params(b, ttype, h, w, magnitude, seed)
    i1 = _warped(torch.as_tensor(host, device=dev), ttype, gt)

    side = int(round(np.sqrt(occl_frac * h * w)))
    side = max(4, min(side, min(h, w) - 1))
    other = np.roll(host, 1, axis=0)
    i2 = host.copy()
    mask = np.zeros((b, h, w), bool)
    for k in range(b):
        y0 = int(rng.integers(0, h - side + 1))
        x0 = int(rng.integers(0, w - side + 1))
        i2[k, y0:y0 + side, x0:x0 + side] = other[k, :side, :side]
        mask[k, y0:y0 + side, x0:x0 + side] = True
    return i1, torch.as_tensor(i2, device=dev), gt, mask


def _score(i1, i2, gt: np.ndarray, config: AlignConfig) -> EvalResult:
    """Align the pairs once from p0 = 0, timed on the host clock."""
    config.validate()
    b = i1.shape[0]
    p0 = torch.zeros((b, 8), dtype=torch.float32, device=i1.device)
    cuda = i1.is_cuda
    if cuda:
        _build.load_library()        # a first use compiles: not the run's time
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = _align_impl(i1, i2, p0, config)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    k = nparams(config.transform)
    err = res.p[:, :k].double().cpu().numpy() - gt[:, :k]
    error = res.error.cpu().numpy()
    diverged = res.diverged.cpu().numpy()
    return EvalResult(
        transform=config.transform.name,
        robust=config.robust.name,
        nscales=config.nscales,
        batch=b,
        mse=float((err ** 2).mean()),
        mae=float(np.abs(err).mean()),
        max_err=float(np.abs(err).max()),
        pairs_per_sec=b / dt,
        seconds=dt,
        mean_iters=float(res.niters.double().mean()),
        converged_frac=float(((error <= config.tol) & ~diverged).mean()),
        diverged_frac=float(diverged.mean()),
    )


def evaluate(images, config: AlignConfig, magnitude: float = 3.0, seed: int = 0,
             device=None) -> EvalResult:
    """Align a randomly-warped copy of every image on `device` (CUDA by
    default); report accuracy and speed of that one run (p0 = 0, the
    reference evaluator's setting)."""
    i1, i2, gt = make_pairs(images, config.transform, magnitude, seed, device)
    return _score(i1, i2, gt, config)


def evaluate_occlusion(images, base: AlignConfig = AlignConfig(),
                       magnitude: float = 3.0, occl_frac: float = 0.2,
                       seed: int = 0, device=None) -> list[EvalResult]:
    """QUADRATIC vs every robust loss on occluded pairs (the separation
    the clean sweeps cannot show: on clean synthetic warps all losses are
    indistinguishable)."""
    i1, i2, gt, _ = make_occluded_pairs(images, base.transform, magnitude,
                                        occl_frac, seed, device)
    return [_score(i1, i2, gt, base.replace(robust=r)) for r in RobustLoss]


def evaluate_transforms(images, base: AlignConfig = AlignConfig(),
                        magnitude: float = 3.0, device=None) -> list[EvalResult]:
    """Sweep over all five motion models (reference colab cell 18)."""
    return [evaluate(images, base.replace(transform=t), magnitude, device=device)
            for t in TransformType]


def evaluate_robust_losses(images, base: AlignConfig = AlignConfig(),
                           magnitude: float = 3.0, device=None) -> list[EvalResult]:
    """Sweep over robust error functions (reference colab cell 24). Every
    loss runs the annealed-lambda schedule (lam=0 -> LAMBDA_0 80 shrinking
    x0.9 to LAMBDA_N 5); a fixed lam=5 hard truncation fails
    TRUNCATED_QUADRATIC on saturation-clipped content (JAX package,
    EVAL_r05.json)."""
    return [evaluate(images, base.replace(robust=r), magnitude, device=device)
            for r in RobustLoss]


def evaluate_pyramid_levels(images, base: AlignConfig = AlignConfig(),
                            levels=(3, 4, 5), magnitude: float = 3.0,
                            device=None) -> list[EvalResult]:
    """Sweep over pyramid depth (reference colab cell 29)."""
    return [evaluate(images, base.replace(nscales=n), magnitude, device=device)
            for n in levels]
