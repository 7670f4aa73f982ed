"""User-facing alignment API.

`align(I1, I2, config)` covers the reference's three algorithms (quadratic,
robust, pyramidal: src/inverse_compositional_algorithm.py:17,135,264).
Images are [H, W, C] or [B, H, W, C] tensors or numpy arrays. Tensors stay
on their device: CUDA tensors run the hand-written kernels, CPU tensors
their plain versions. Numpy inputs go to CUDA unless `device` names another
device (`device="cpu"` for the plain path); without a CUDA device they raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import AlignConfig
from ..ops.kernels.warp import warp_image_fast
from ..ops.transforms import (
    TransformType,
    invert_params,
    nparams,
    pad_params,
    transform_grid,
)
from ..ops.warp import bicubic_sample, warp_image
from .pyramidal import pyramidal_solve

__all__ = ["AlignResult", "align", "warp", "transform_image", "default_device"]


@dataclass
class AlignResult:
    """The reference's (p, error, DI, Iw) return tuple
    (src/inverse_compositional_algorithm.py:133), plus per-pair iteration
    counts, the validity mask of the final warp and the divergence flags."""

    p: torch.Tensor         # [B, 8] padded final parameters (or [8] for single input)
    error: torch.Tensor     # [B] final ||dp||
    niters: torch.Tensor    # [B] iterations applied at the finest scale
    di: torch.Tensor        # [B, H, W, C] final error image Iw - I1
    iw: torch.Tensor        # [B, H, W, C] final warped I2
    valid: torch.Tensor     # [B, H, W] bool, warp in-domain mask
    diverged: torch.Tensor  # [B] bool, finest-scale divergence guard tripped

    def params(self, config: AlignConfig) -> torch.Tensor:
        """Un-padded parameter vector(s) for the configured model."""
        return self.p[..., : nparams(config.transform)]


def default_device(device=None) -> torch.device:
    """`device` if given, else CUDA; raise when CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on CUDA by "
                           "default; pass device='cpu' to run on the CPU")
    return dev


def _to_tensor(x, dtype: torch.dtype | None, device) -> torch.Tensor:
    """A tensor stays on its device (`device`, if given, must match it); a
    numpy array or list goes to `device`, CUDA by default (`default_device`).
    dtype None keeps a tensor's dtype and makes other input float32."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            want = torch.device(device)
            if x.device.type != want.type or (want.index is not None
                                              and x.device.index != want.index):
                raise ValueError(f"tensor is on {x.device}, but device={device}")
        return x if dtype is None else x.to(dtype)
    return torch.tensor(np.asarray(x), dtype=dtype or torch.float32,
                        device=default_device(device))


def _align_impl(i1: torch.Tensor, i2: torch.Tensor, p0: torch.Tensor,
                config: AlignConfig) -> AlignResult:
    """Batched pipeline: pyramid solve, then the final warp (K3 on CUDA)."""
    state, _ = pyramidal_solve(
        i1, i2, p0, config.transform,
        nscales=config.nscales, nu=config.nu, tol=config.tol,
        max_iter=config.max_iter, robust=config.robust, lam=config.lam,
        nanifoutside=config.nanifoutside, delta=config.delta,
        pyramid_method=config.pyramid_method,
        precondition=config.precondition,
        hessian_chunk=config.hessian_chunk, verbose=config.verbose,
        divergence_guard=config.divergence_guard,
        delta_cap=config.delta_cap,
    )
    return _final_warp(state, i1, i2, config)


def _final_warp(state, i1: torch.Tensor, i2: torch.Tensor, config: AlignConfig,
                y_offset: int = 0) -> AlignResult:
    """The result of a solve: I2 warped (K3 on CUDA) at the solved motion on
    the template rows i1 covers, rows y_offset .. y_offset + i1.shape[1] - 1
    of the frame (all of them unless the rows are tiled)."""
    gx, gy = transform_grid(state.p, config.transform, i1.shape[1], i2.shape[2],
                            y_offset=y_offset)
    iw, valid = warp_image_fast(i2, i2.permute(0, 3, 1, 2).contiguous(), gx, gy,
                                config.delta)
    fill = float("nan") if config.nanifoutside else 0.0
    iw = torch.where(valid[..., None], iw, torch.full_like(iw, fill))
    return AlignResult(p=state.p, error=state.error, niters=state.niters,
                       di=iw - i1, iw=iw, valid=valid, diverged=state.diverged)


def align(i1, i2, config: AlignConfig = AlignConfig(), p0=None,
          dtype: torch.dtype = torch.float32, device=None) -> AlignResult:
    """Estimate the parametric motion warping I2 onto I1.

    Args:
      i1, i2: [H, W, C] or [B, H, W, C] images (cast to `dtype`; raw 0..255
        values as in the reference).
      config: algorithm configuration.
      p0: optional warm start, [k], [8], [B, k] or [B, 8].
      device: where numpy inputs go, CUDA by default (raises without a CUDA
        device; pass "cpu" for the plain path); for tensors, optional and
        must match.

    Returns:
      AlignResult (batch dims match the input rank).
    """
    config.validate()
    i1 = _to_tensor(i1, dtype, device)
    i2 = _to_tensor(i2, dtype, device)
    if i1.device != i2.device:
        raise ValueError(f"I1 is on {i1.device} and I2 on {i2.device}")
    if i1.shape != i2.shape:
        raise ValueError("I1 and I2 must have the same shape")
    single = i1.ndim == 3
    if single:
        i1, i2 = i1[None], i2[None]
    if i1.ndim != 4:
        raise ValueError("images must be [H, W, C] or [B, H, W, C]")

    b = i1.shape[0]
    if p0 is None:
        p0 = torch.zeros((b, 8), dtype=dtype, device=i1.device)
    else:
        p0 = pad_params(_to_tensor(p0, dtype, i1.device))
        if p0.ndim == 1:
            p0 = p0.expand(b, 8)

    res = _align_impl(i1, i2, p0, config)
    if single:
        res = AlignResult(p=res.p[0], error=res.error[0], niters=res.niters[0],
                          di=res.di[0], iw=res.iw[0], valid=res.valid[0],
                          diverged=res.diverged[0])
    return res


def warp(image, p, config: AlignConfig = AlignConfig(), device=None) -> torch.Tensor:
    """Warp an image (or batch) by parameters p, NaN- or 0-filling
    out-of-domain pixels per config.nanifoutside (the reference's
    `bicubic_interpolation_skimage` surface). Numpy input goes to `device`,
    CUDA by default, as in `align`."""
    image = _to_tensor(image, None, device)
    single = image.ndim == 3
    if single:
        image = image[None]
    p = _to_tensor(p, image.dtype, image.device)
    if p.ndim == 1:
        p = p[None]
    iw, valid = warp_image(image, pad_params(p), config.transform, config.delta)
    fill = float("nan") if config.nanifoutside else 0.0
    iw = torch.where(valid[..., None], iw, torch.full_like(iw, fill))
    return iw[0] if single else iw


def transform_image(image, ttype: TransformType, gt, device=None) -> torch.Tensor:
    """Apply the forward motion `gt`: out(x) = I(M(gt)^-1 x), so aligning
    (out, I) recovers p = params(M(gt)^-1) (reference
    src/transformation.py:266-318; every model uses params_to_matrix(gt)
    unmodified, see PARITY.md C23). Numpy input goes to `device`, CUDA by
    default, as in `align`."""
    image = _to_tensor(image, None, device)
    single = image.ndim == 3
    if single:
        image = image[None]
    b, hh, ww, _ = image.shape
    p_inv = invert_params(pad_params(_to_tensor(gt, image.dtype, image.device), ttype), ttype)
    if p_inv.ndim == 1:
        p_inv = p_inv.expand(b, 8)
    gx, gy = transform_grid(p_inv, ttype, hh, ww)
    out = bicubic_sample(image, gx, gy)
    return out[0] if single else out
