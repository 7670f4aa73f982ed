"""Weighted normal equations via coordinate moments (kernel K4).

The per-iteration Gauss-Newton system is

    H[b] = sum_p  w1 Jx Jx^T + w2 (Jx Jy^T + Jy Jx^T) + w3 Jy Jy^T
    r[b] = sum_p  wu Jx + wv Jy

Every Jacobian column is a polynomial of degree <= 2 in the pixel
coordinates, so every entry of H and r is a fixed linear combination of

    M_k[b, a] = sum_p w_k(p) * (x/L)^a * (y/L)^b,     a, b in 0..4,

with L = max(H, W). `weighted_moments` computes the moments (a CUDA kernel
on CUDA tensors, `weighted_moments_ref` on CPU tensors); the small
type-specific assembly H = T_H . M, r = T_b . M is an einsum with constant
tensors. Normalizing by L is the Hartley preconditioning of
`ops.transforms.param_preconditioner`, so the assembled system is the
preconditioned one.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...constants import NPARAMS_MAX
from ..transforms import TransformType
from . import _build

__all__ = ["weighted_moments", "weighted_moments_ref", "fused_normal_eq",
           "fused_hessian", "fused_rhs", "LAUNCHES"]

_DEG = 5          # moment powers 0..4
_PAD = 8          # moment matrices are returned padded to [8, 8]

# Number of times `weighted_moments` launched its CUDA kernel.
LAUNCHES = 0


def _powers(n: int, inv_l: float, offset: int, like: torch.Tensor) -> torch.Tensor:
    """[n, 5]: ((i + offset) * inv_l)^a for a < 5, by repeated
    multiplication as the kernels form them."""
    base = (torch.arange(n, device=like.device) + offset).to(like.dtype) * inv_l
    cols = [torch.ones_like(base)]
    for _ in range(1, _DEG):
        cols.append(cols[-1] * base)
    return torch.stack(cols, dim=-1)


def moments_ref(maps: torch.Tensor, inv_l: float, y_offset: int = 0) -> torch.Tensor:
    """[B, K, H, W] -> [B, K, 8, 8]: M[b,k,j,i] = sum maps * (x*inv_l)^i *
    ((y + y_offset)*inv_l)^j for i, j < 5, zero elsewhere (plain version of
    the moment epilogue shared by K1 and K4)."""
    b, k, h, w = maps.shape
    xp = _powers(w, inv_l, 0, maps)
    yp = _powers(h, inv_l, y_offset, maps)
    m = torch.einsum("bkyx,xi,yj->bkji", maps, xp, yp)
    out = torch.zeros((b, k, _PAD, _PAD), dtype=maps.dtype, device=maps.device)
    out[:, :, :_DEG, :_DEG] = m
    return out


def weighted_moments_ref(maps: torch.Tensor) -> torch.Tensor:
    """Plain version of `weighted_moments` (the contraction of
    ops/pallas/normal_eq.py::_moment_kernel as one einsum)."""
    _, _, h, w = maps.shape
    return moments_ref(maps, 1.0 / float(max(h, w)))


def weighted_moments(maps: torch.Tensor) -> torch.Tensor:
    """maps [B, K, H, W] -> [B, K, 8, 8] coordinate moments
    M[b, k, j, i] = sum_p maps[b,k,p] * (x/L)^i * (y/L)^j (i, j < 5).

    CUDA tensors run csrc/weighted_moments.cu (float32, contiguous, K <= 5);
    CPU tensors take `weighted_moments_ref`.
    """
    global LAUNCHES
    if not _build.use_kernel(maps):
        return weighted_moments_ref(maps)
    b, k, h, w = maps.shape
    _build.check_operand(maps, "maps", (b, k, h, w))
    if not 1 <= k <= 5:
        raise ValueError(f"the CUDA kernel takes 1 to 5 maps, got {k}")
    ntiles = -(-h // 8)
    partial = torch.empty((b, k, ntiles, _DEG * _DEG), dtype=torch.float32,
                          device=maps.device)
    out = torch.empty((b, k, _PAD, _PAD), dtype=torch.float32, device=maps.device)
    _build.launch("ica_weighted_moments", maps, partial, out, b, k, h, w,
                  1.0 / float(max(h, w)))
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Type-specific assembly tensors (static, numpy)

def _column_polys(ttype: TransformType, l: float):
    """Per parameter column n: 3x3 coefficient grids [y-pow, x-pow] of the
    preconditioned Jacobian columns in normalized coordinates (x/L, y/L)."""
    def g(**terms):
        c = np.zeros((3, 3))
        for key, v in terms.items():
            a, b = int(key[1]), int(key[2])   # key like "p10" = x^1 y^0
            c[b, a] = v
        return c

    zero = g()
    one = g(p00=1.0)
    x = g(p10=1.0)
    y = g(p01=1.0)
    if ttype is TransformType.TRANSLATION:
        jx = [one, zero]
        jy = [zero, one]
        scale = [1.0, 1.0]
    elif ttype is TransformType.EUCLIDEAN:
        jx = [one, zero, -y]
        jy = [zero, one, x]
        scale = [1.0, 1.0, l]
    elif ttype is TransformType.SIMILARITY:
        jx = [one, zero, x, -y]
        jy = [zero, one, y, x]
        scale = [1.0, 1.0, l, l]
    elif ttype is TransformType.AFFINITY:
        jx = [one, zero, x, y, zero, zero]
        jy = [zero, one, zero, zero, x, y]
        scale = [1.0, 1.0, l, l, l, l]
    elif ttype is TransformType.HOMOGRAPHY:
        x2 = g(p20=-1.0)
        xy = g(p11=-1.0)
        y2 = g(p02=-1.0)
        jx = [x, y, one, zero, zero, zero, x2, xy]
        jy = [zero, zero, zero, x, y, one, xy, y2]
        scale = [l, l, 1.0, l, l, 1.0, l * l, l * l]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")

    k = len(jx)
    pad = [zero] * (NPARAMS_MAX - k)
    return jx + pad, jy + pad, scale + [1.0] * (NPARAMS_MAX - k)


@lru_cache(maxsize=None)
def _assembly(ttype: TransformType, height: int, width: int):
    """(T_h [8,8,3,5,5], T_b [8,2,5,5]) float32 numpy contraction tensors:
    H[n,m] = sum_{k,j,i} T_h[n,m,k,j,i] * M[k,j,i] with k over (w1,w2,w3);
    r[n]   = sum_{k,j,i} T_b[n,k,j,i] * M[3+k,j,i] with k over (wu,wv)."""
    jx, jy, _ = _column_polys(ttype, float(max(height, width)))

    def polymul(a, b):
        out = np.zeros((_DEG, _DEG))
        for (i, j), va in np.ndenumerate(a):
            if va == 0:
                continue
            for (k, m), vb in np.ndenumerate(b):
                if vb == 0:
                    continue
                out[i + k, j + m] += va * vb
        return out

    t_h = np.zeros((NPARAMS_MAX, NPARAMS_MAX, 3, _DEG, _DEG))
    for n in range(NPARAMS_MAX):
        for m in range(NPARAMS_MAX):
            t_h[n, m, 0] = polymul(jx[n], jx[m])
            t_h[n, m, 1] = polymul(jx[n], jy[m]) + polymul(jy[n], jx[m])
            t_h[n, m, 2] = polymul(jy[n], jy[m])
    t_b = np.zeros((NPARAMS_MAX, 2, _DEG, _DEG))
    for n in range(NPARAMS_MAX):
        t_b[n, 0, :3, :3] = jx[n]
        t_b[n, 1, :3, :3] = jy[n]
    return t_h.astype(np.float32), t_b.astype(np.float32)


@lru_cache(maxsize=None)
def _assembly_tensors(ttype: TransformType, height: int, width: int,
                      device: torch.device, dtype: torch.dtype):
    t_h, t_b = _assembly(ttype, height, width)
    return (torch.as_tensor(t_h, device=device, dtype=dtype),
            torch.as_tensor(t_b, device=device, dtype=dtype))


def _assemble_h(m: torch.Tensor, ttype: TransformType, h: int, w: int) -> torch.Tensor:
    """H [B, 8, 8] from the (w1, w2, w3) moments m [B, 3, 8, 8]."""
    t_h, _ = _assembly_tensors(ttype, h, w, m.device, m.dtype)
    return torch.einsum("bkji,nmkji->bnm", m[:, :, :_DEG, :_DEG], t_h)


def _assemble_b(m: torch.Tensor, ttype: TransformType, h: int, w: int) -> torch.Tensor:
    """r [B, 8] from the (wu, wv) moments m [B, 2, 8, 8]."""
    _, t_b = _assembly_tensors(ttype, h, w, m.device, m.dtype)
    return torch.einsum("bkji,nkji->bn", m[:, :, :_DEG, :_DEG], t_b)


def fused_normal_eq(w1, w2, w3, wu, wv, *, ttype: TransformType):
    """H [B,8,8] and r [B,8] (preconditioned metric) from five [B,H,W] maps."""
    _, h, w = w1.shape
    m = weighted_moments(torch.stack([w1, w2, w3, wu, wv], dim=1))
    return _assemble_h(m[:, :3], ttype, h, w), _assemble_b(m[:, 3:], ttype, h, w)


def fused_hessian(w1, w2, w3, *, ttype: TransformType) -> torch.Tensor:
    """H [B,8,8] alone (the quadratic algorithm's hoisted Hessian)."""
    _, h, w = w1.shape
    return _assemble_h(weighted_moments(torch.stack([w1, w2, w3], dim=1)), ttype, h, w)


def fused_rhs(wu, wv, *, ttype: TransformType) -> torch.Tensor:
    """r [B,8] alone."""
    _, h, w = wu.shape
    return _assemble_b(weighted_moments(torch.stack([wu, wv], dim=1)), ttype, h, w)
