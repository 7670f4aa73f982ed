"""Gauss-Newton normal equations, channel-reduced (plain PyTorch).

The per-pixel steepest-descent vector factorizes as
d_n(p,c) = Ix(p,c) * Jx_n(p) + Iy(p,c) * Jy_n(p), so all channel sums are
taken first and the system reduces to six scalar maps per pair:

    gxx = sum_c Ix^2, gxy = sum_c Ix*Iy, gyy = sum_c Iy^2   (precomputed)
    u   = sum_c Ix*DI, v = sum_c Iy*DI                       (per iteration)

    b_n    = sum_p w_p (u_p Jx_n + v_p Jy_n)
    H_{nm} = sum_p w_p (gxx JxJx + gxy (JxJy + JyJx) + gyy JyJy)_{nm}

with w the IRLS weight rho' (1 for the quadratic algorithm). This is the
CPU path of the solver; on CUDA the same sums come from the moment kernels
(ops/kernels/normal_eq.py, ops/kernels/fused_iter.py).
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F

from ..constants import NPARAMS_MAX

__all__ = [
    "RobustLoss",
    "rhop",
    "grad_moments",
    "residual_moments",
    "robust_weights",
    "hessian",
    "rhs",
    "cholesky_solve8",
    "solve_normal",
]


class RobustLoss(enum.Enum):
    """Robust error function rho (reference: src/image_optimisation.py:10-15)."""

    QUADRATIC = 0
    TRUNCATED_QUADRATIC = 1
    GERMAN_MCCLURE = 2
    LORENTZIAN = 3
    CHARBONNIER = 4


def rhop(t2: torch.Tensor, lam, loss: RobustLoss) -> torch.Tensor:
    """rho'(t^2; lambda), vectorized (semantics of `tf_rhop`,
    src/keras-tf/tf_image_optimisation.py:7-43). `lam` is a number or a
    tensor that broadcasts against t2 (per-pair lambda)."""
    lam2 = lam * lam
    if loss is RobustLoss.QUADRATIC:
        return torch.ones_like(t2)
    if loss is RobustLoss.TRUNCATED_QUADRATIC:
        return torch.where(t2 < lam2, torch.ones_like(t2), torch.zeros_like(t2))
    if loss is RobustLoss.GERMAN_MCCLURE:
        return lam2 / torch.square(lam2 + t2)
    if loss is RobustLoss.LORENTZIAN:
        return 1.0 / (lam2 + t2)
    if loss is RobustLoss.CHARBONNIER:
        return torch.rsqrt(t2 + lam2)
    raise ValueError(f"unknown robust loss {loss}")


def grad_moments(ix: torch.Tensor, iy: torch.Tensor):
    """(gxx, gxy, gyy), each [B, H, W], from band-masked gradients [B, H, W, C]."""
    return ((ix * ix).sum(-1), (ix * iy).sum(-1), (iy * iy).sum(-1))


def residual_moments(ix: torch.Tensor, iy: torch.Tensor, di: torch.Tensor):
    """u = sum_c Ix*DI, v = sum_c Iy*DI for the masked residual `di`."""
    return (ix * di).sum(-1), (iy * di).sum(-1)


def robust_weights(di: torch.Tensor, lam, loss: RobustLoss) -> torch.Tensor:
    """Per-pixel IRLS weight rho'(sum_c DI^2; lambda) of the masked residual."""
    return rhop((di * di).sum(-1), lam, loss)


def _flatten_chunks(arr: torch.Tensor, chunk: int) -> torch.Tensor:
    """[..., P] -> [..., nchunks, chunk], zero-padded."""
    p = arr.shape[-1]
    nchunks = -(-p // chunk)
    arr = F.pad(arr, (0, nchunks * chunk - p))
    return arr.reshape(*arr.shape[:-1], nchunks, chunk)


def hessian(gxx, gxy, gyy, jx, jy, weights=None, chunk: int = 16384) -> torch.Tensor:
    """H[b] = sum_p w (gxx JxJx^T + gxy (JxJy^T + JyJx^T) + gyy JyJy^T), [B, 8, 8].

    gxx, gxy, gyy, weights: [B, H, W]; jx, jy: [H, W, 8]. Accumulated over
    pixel chunks so the transient stays [B, chunk, 8].
    """
    b = gxx.shape[0]
    if weights is not None:
        gxx, gxy, gyy = gxx * weights, gxy * weights, gyy * weights
    w1, w2, w3 = (_flatten_chunks(m.reshape(b, -1), chunk) for m in (gxx, gxy, gyy))
    jxc = _flatten_chunks(jx.reshape(-1, NPARAMS_MAX).T, chunk)   # [8, n, chunk]
    jyc = _flatten_chunks(jy.reshape(-1, NPARAMS_MAX).T, chunk)
    h = torch.zeros((b, NPARAMS_MAX, NPARAMS_MAX), dtype=gxx.dtype, device=gxx.device)
    for k in range(w1.shape[1]):
        jxk, jyk = jxc[:, k].T, jyc[:, k].T                       # [chunk, 8]
        xx = torch.einsum("bp,pn,pm->bnm", w1[:, k], jxk, jxk)
        xy = torch.einsum("bp,pn,pm->bnm", w2[:, k], jxk, jyk)
        yy = torch.einsum("bp,pn,pm->bnm", w3[:, k], jyk, jyk)
        h = h + xx + xy + xy.transpose(1, 2) + yy
    return h


def rhs(u, v, jx, jy, weights=None) -> torch.Tensor:
    """b[b] = sum_p w (u_p Jx + v_p Jy), [B, 8]."""
    b = u.shape[0]
    uf = u.reshape(b, -1)
    vf = v.reshape(b, -1)
    if weights is not None:
        wf = weights.reshape(b, -1)
        uf = uf * wf
        vf = vf * wf
    return uf @ jx.reshape(-1, NPARAMS_MAX) + vf @ jy.reshape(-1, NPARAMS_MAX)


def cholesky_solve8(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve H x = b through an unrolled Cholesky factorization.

    h: [B, n, n], b: [B, n]. A non-SPD input gives NaNs, which the caller
    maps to dp = 0.
    """
    n = h.shape[-1]
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = h[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        ljj = torch.sqrt(s)
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, n):
            s = h[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def solve_normal(h: torch.Tensor, b: torch.Tensor, live, precond=None):
    """Solve H dp = b per pair; returns (dp [B, 8], error [B] = ||dp||).

    live: [8] 0/1 mask of the model's real parameters; padded slots get an
    identity diagonal. precond: optional [8] column scales; dp is returned
    de-preconditioned (dp / s). A non-finite solve (singular H) gives
    dp = 0, the reference's fallback (src/derivatives.py:126-129).
    """
    live = torch.as_tensor(live, dtype=h.dtype, device=h.device)
    dp = cholesky_solve8(h + torch.diag(1.0 - live)[None], b)
    if precond is not None:
        dp = dp / torch.as_tensor(precond, dtype=dp.dtype, device=dp.device)
    finite = torch.isfinite(dp).all(dim=-1, keepdim=True)
    dp = torch.where(finite, dp, torch.zeros_like(dp)) * live
    return dp, torch.linalg.vector_norm(dp, dim=-1)
