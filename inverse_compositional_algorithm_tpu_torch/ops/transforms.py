"""Geometry core: parametric motion models and inverse-compositional algebra.

PyTorch counterpart of `inverse_compositional_algorithm_tpu.ops.transforms`.
Five global motion models (translation, euclidean, similarity, affinity,
homography) share one padded 8-parameter state and are routed through
batched 3x3 homogeneous matrices.

Parameter layouts (identical to reference src/transformation.py:157-182):
  TRANSLATION  p = (tx, ty)
  EUCLIDEAN    p = (tx, ty, theta)
  SIMILARITY   p = (tx, ty, a, b)       -> [[1+a, -b], [b, 1+a]]
  AFFINITY     p = (tx, ty, a00, a01, a10, a11)
  HOMOGRAPHY   p = (h00, h01, h02, h10, h11, h12, h20, h21), H22 = 1

All public functions take and return padded parameters of shape [..., 8]
with unused slots zero. Outputs live on the device and in the dtype of the
parameters they are computed from.
"""

from __future__ import annotations

import enum

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import NPARAMS_MAX

__all__ = [
    "TransformType",
    "nparams",
    "pad_params",
    "params_to_matrix",
    "matrix_to_params",
    "compose_inverse",
    "invert_params",
    "transform_grid",
    "matrix_grid",
    "transform_points",
    "jacobian_fields",
    "param_preconditioner",
    "zoom_in_params",
]


class TransformType(enum.Enum):
    """Motion model (reference: src/transformation.py:8-13)."""

    TRANSLATION = 1
    EUCLIDEAN = 2
    SIMILARITY = 3
    AFFINITY = 4
    HOMOGRAPHY = 5

    @property
    def n(self) -> int:
        return _NPARAMS[self]


_NPARAMS = {
    TransformType.TRANSLATION: 2,
    TransformType.EUCLIDEAN: 3,
    TransformType.SIMILARITY: 4,
    TransformType.AFFINITY: 6,
    TransformType.HOMOGRAPHY: 8,
}


def nparams(ttype: TransformType) -> int:
    """Number of live parameters of the model (reference: src/transformation.py:16-32)."""
    return _NPARAMS[ttype]


def pad_params(p: torch.Tensor, ttype: TransformType | None = None) -> torch.Tensor:
    """Pad a [..., k] parameter tensor with zeros up to [..., 8]."""
    k = p.shape[-1]
    if k == NPARAMS_MAX:
        return p
    if k > NPARAMS_MAX:
        raise ValueError(f"parameter vector has {k} > {NPARAMS_MAX} entries")
    return F.pad(p, (0, NPARAMS_MAX - k))


def params_to_matrix(p: torch.Tensor, ttype: TransformType) -> torch.Tensor:
    """Batched params -> homogeneous 3x3 matrices, shape [..., 3, 3]
    (reference src/transformation.py:188-236, params2matrix)."""
    p = pad_params(p, ttype)
    one = torch.ones_like(p[..., 0])
    zero = torch.zeros_like(p[..., 0])
    tx, ty = p[..., 0], p[..., 1]

    if ttype is TransformType.TRANSLATION:
        rows = [one, zero, tx, zero, one, ty, zero, zero, one]
    elif ttype is TransformType.EUCLIDEAN:
        c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
        rows = [c, -s, tx, s, c, ty, zero, zero, one]
    elif ttype is TransformType.SIMILARITY:
        a, b = p[..., 2], p[..., 3]
        rows = [one + a, -b, tx, b, one + a, ty, zero, zero, one]
    elif ttype is TransformType.AFFINITY:
        a00, a01, a10, a11 = p[..., 2], p[..., 3], p[..., 4], p[..., 5]
        rows = [one + a00, a01, tx, a10, one + a11, ty, zero, zero, one]
    elif ttype is TransformType.HOMOGRAPHY:
        rows = [
            one + p[..., 0], p[..., 1], p[..., 2],
            p[..., 3], one + p[..., 4], p[..., 5],
            p[..., 6], p[..., 7], one,
        ]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")
    return torch.stack(rows, dim=-1).reshape(*p.shape[:-1], 3, 3)


def matrix_to_params(m: torch.Tensor, ttype: TransformType) -> torch.Tensor:
    """Homogeneous 3x3 matrices (normalized, m[2,2] == 1) -> padded [..., 8]
    params (reference src/transformation.py:238-263)."""
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    if ttype is TransformType.TRANSLATION:
        cols = [tx, ty]
    elif ttype is TransformType.EUCLIDEAN:
        cols = [tx, ty, torch.atan2(m[..., 1, 0], m[..., 0, 0])]
    elif ttype is TransformType.SIMILARITY:
        cols = [tx, ty, m[..., 0, 0] - 1, m[..., 1, 0]]
    elif ttype is TransformType.AFFINITY:
        cols = [tx, ty, m[..., 0, 0] - 1, m[..., 0, 1], m[..., 1, 0], m[..., 1, 1] - 1]
    elif ttype is TransformType.HOMOGRAPHY:
        cols = [
            m[..., 0, 0] - 1, m[..., 0, 1], m[..., 0, 2],
            m[..., 1, 0], m[..., 1, 1] - 1, m[..., 1, 2],
            m[..., 2, 0], m[..., 2, 1],
        ]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")
    return pad_params(torch.stack(cols, dim=-1))


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate of [..., 3, 3] (det(M) * inv(M), with no division)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        dim=-1,
    )
    return adj.reshape(*m.shape[:-2], 3, 3)


def _normalize_guarded(u: torch.Tensor, fallback: torch.Tensor,
                       ttype: TransformType, guard: float) -> torch.Tensor:
    """params(u / u[2,2]), or `fallback` where u[2,2]^2 <= guard."""
    w = u[..., 2, 2]
    ok = (w * w) > guard
    safe_w = torch.where(ok, w, torch.ones_like(w))
    new = matrix_to_params(u / safe_w[..., None, None], ttype)
    return torch.where(ok[..., None], new, fallback)


def compose_inverse(p: torch.Tensor, dp: torch.Tensor, ttype: TransformType,
                    guard: float = 1e-10) -> torch.Tensor:
    """Inverse-compositional update p <- p o dp^{-1}
    (reference src/transformation.py:36-141, `update_transform`).

    M(p) @ adj(M(dp)) normalized by its homogeneous scale; updates whose
    normalizer^2 <= guard leave p unchanged (the reference's `det*det > 1E-10`
    guards, src/transformation.py:79,98,131). TRANSLATION is exactly p - dp.
    """
    p = pad_params(p, ttype)
    dp = pad_params(dp, ttype)
    if ttype is TransformType.TRANSLATION:
        new = p.clone()
        new[..., :2] = p[..., :2] - dp[..., :2]
        return new
    u = torch.matmul(params_to_matrix(p, ttype),
                     _adjugate3(params_to_matrix(dp, ttype)))
    return _normalize_guarded(u, p, ttype, guard)


def invert_params(p: torch.Tensor, ttype: TransformType,
                  guard: float = 1e-10) -> torch.Tensor:
    """Parameters of the inverse transform, params(M(p)^{-1})."""
    p = pad_params(p, ttype)
    return _normalize_guarded(_adjugate3(params_to_matrix(p, ttype)), p,
                              ttype, guard)


def transform_grid(p: torch.Tensor, ttype: TransformType, height: int,
                   width: int, y_offset: int = 0):
    """Warped sampling coordinates x'(x; p) for every pixel.

    Args:
      p: [..., 8] padded parameters.
      height, width: image dims.
      y_offset: global row index of the first row (for row tiles).

    Returns:
      (gx, gy): each [..., height, width], matching reference `project`
      (src/transformation.py:144-186).
    """
    p = pad_params(p, ttype)
    return matrix_grid(params_to_matrix(p, ttype), ttype is TransformType.HOMOGRAPHY,
                       height, width, y_offset)


def matrix_grid(m: torch.Tensor, projective: bool, height: int, width: int,
                y_offset: int = 0):
    """`transform_grid` from the motion matrices m [..., 3, 3]: per pixel
    ((m[r,0] * x) + (m[r,1] * y)) + m[r,2] for rows 0 and 1, divided by
    row 2 when `projective`, each operation rounded on its own. The fused
    iteration kernel forms its coordinates in this order."""
    x = torch.arange(width, dtype=m.dtype, device=m.device)
    y = torch.arange(height, dtype=m.dtype, device=m.device) + y_offset
    mm = m[..., None, None]

    def row(r):
        return (mm[..., r, 0, :, :] * x[None, :] + mm[..., r, 1, :, :] * y[:, None]
                + mm[..., r, 2, :, :])

    gx, gy = row(0), row(1)
    if projective:
        d = row(2)
        gx = gx / d
        gy = gy / d
    return gx, gy


def transform_points(p: torch.Tensor, ttype: TransformType, xs, ys):
    """Map points (xs, ys) [K], shared across the batch, through the warp:
    returns (gx, gy) each [..., K]."""
    p = pad_params(p, ttype)
    m = params_to_matrix(p, ttype)
    xs = torch.as_tensor(xs, dtype=p.dtype, device=p.device)
    ys = torch.as_tensor(ys, dtype=p.dtype, device=p.device)

    def row(r):
        return m[..., r, 0, None] * xs + m[..., r, 1, None] * ys + m[..., r, 2, None]

    gx, gy = row(0), row(1)
    if ttype is TransformType.HOMOGRAPHY:
        d = row(2)
        gx = gx / d
        gy = gy / d
    return gx, gy


def jacobian_fields(ttype: TransformType, height: int, width: int,
                    dtype=torch.float32, scale=None, y_offset: int = 0,
                    device=None):
    """Analytic warp Jacobian dW/dp at p = 0, padded to 8 columns.

    Returns (jx, jy), each [height, width, 8], column layout of reference
    `jacobian` (src/derivatives.py:7-70). `scale` ([8]) divides the columns
    (see `param_preconditioner`).
    """
    x = torch.arange(width, dtype=dtype, device=device)[None, :].expand(height, width)
    y = (torch.arange(height, dtype=dtype, device=device) + y_offset)[:, None]
    y = y.expand(height, width)
    one = torch.ones((height, width), dtype=dtype, device=device)
    zero = torch.zeros((height, width), dtype=dtype, device=device)

    if ttype is TransformType.TRANSLATION:
        jx = [one, zero]
        jy = [zero, one]
    elif ttype is TransformType.EUCLIDEAN:
        jx = [one, zero, -y]
        jy = [zero, one, x]
    elif ttype is TransformType.SIMILARITY:
        jx = [one, zero, x, -y]
        jy = [zero, one, y, x]
    elif ttype is TransformType.AFFINITY:
        jx = [one, zero, x, y, zero, zero]
        jy = [zero, one, zero, zero, x, y]
    elif ttype is TransformType.HOMOGRAPHY:
        jx = [x, y, one, zero, zero, zero, -x * x, -x * y]
        jy = [zero, zero, zero, x, y, one, -x * y, -y * y]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")

    pad = [zero] * (NPARAMS_MAX - len(jx))
    jxs = torch.stack(jx + pad, dim=-1)
    jys = torch.stack(jy + pad, dim=-1)
    if scale is not None:
        s = torch.as_tensor(scale, dtype=dtype, device=device)
        jxs = jxs / s
        jys = jys / s
    return jxs, jys


def param_preconditioner(ttype: TransformType, height: int, width: int) -> np.ndarray:
    """Per-column scales s ([8] numpy float64) for Jacobian preconditioning
    (Hartley normalization with L = max(H, W): linear columns ~L,
    projective columns ~L^2)."""
    L = float(max(height, width))
    ones = np.ones(NPARAMS_MAX, np.float64)
    if ttype is TransformType.EUCLIDEAN:
        ones[2] = L
    elif ttype is TransformType.SIMILARITY:
        ones[2:4] = L
    elif ttype is TransformType.AFFINITY:
        ones[2:6] = L
    elif ttype is TransformType.HOMOGRAPHY:
        ones[[0, 1, 3, 4]] = L
        ones[[6, 7]] = L * L
    return ones


def zoom_in_params(p: torch.Tensor, ttype: TransformType, nx: int, ny: int,
                   nxx: int, nyy: int) -> torch.Tensor:
    """Rescale parameters from pyramid size (nx, ny) to (nxx, nyy): the
    translation-like params scale by nu = max(nxx/nx, nyy/ny), the
    homography's projective row by 1/nu (reference src/zoom.py:62-125)."""
    p = pad_params(p, ttype)
    nu = max(nxx / nx, nyy / ny)
    s = np.ones(NPARAMS_MAX, np.float64)
    if ttype is TransformType.HOMOGRAPHY:
        s[[2, 5]] = nu
        s[[6, 7]] = 1.0 / nu
    else:
        s[[0, 1]] = nu
    return p * torch.as_tensor(s, dtype=p.dtype, device=p.device)
