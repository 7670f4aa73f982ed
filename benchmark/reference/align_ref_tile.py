"""Plain reference of `align` for frames too large to hold whole: the
algorithm of align_ref.py, computed in bands of rows.

The semantics are align_ref's, and so are its pieces (motion models, Keys
sampler, pyramid operators, loss weights, Hessian contraction, forks,
guard), imported from it; only where the work is held differs:

- the finest level stays in the caller's dtype (uint8 frames are read as
  they are, exactly) and is converted band by band;
- the pyramid's first product, and every level's gradients, sampling,
  weights and normal equations, are formed over bands of about `band_px`
  pixels a candidate row and summed, in float64 by default; a band's rows
  get their neighbours for the central differences, so each pixel's value
  is align_ref's, and only the order of the sums over pixels differs;
- the final warp is written band by band into float32 planes: the float64
  result rounded once, at most 1.5e-5 grey levels off for 0..255;
- a pyramid operator is formed tap by tap (`zoom_operator`), not by a dense
  product over the frame's length, which at 10980 px costs 1.3 TFLOP on
  the host.

A 10980 x 10980 four-band pair then needs about 8 GB beside its result,
where align_ref holds every plane of the finest level at once (about 50 GB
in float64). It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .align_ref import (  # noqa: F401 - corner_gap_px and grid serve benchmark/check.py
    LAMBDA_0,
    LAMBDA_N,
    LAMBDA_RATIO,
    NPARAMS,
    ZOOM_SIGMA_ZERO,
    RefResult,
    Rows,
    _gauss,
    _hessian,
    _lost_overlap,
    compose_inverse,
    corner_gap_px,
    grid,
    in_domain,
    keys,
    level_shapes,
    params_to_matrix,
    preconditioner,
    rho_prime,
    zoom_in,
)

BAND_PX = 1 << 22


def _bands(h: int, w: int, nrows: int, band_px: int):
    step = max(1, band_px // max(1, w * nrows))
    return [(y0, min(h, y0 + step)) for y0 in range(0, h, step)]


@lru_cache(maxsize=None)
def zoom_operator(n: int, m: int, nu: float) -> np.ndarray:
    """align_ref.zoom_operator's [n, m] float64 matrix: the same blur, and
    its product with the Keys resampler taken as four weighted gathers of
    the blur's columns (the sums of the dense product's nonzero terms, in
    another order)."""
    k = _gauss(ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (nu * nu) - 1.0))
    r = (k.size - 1) // 2
    src = np.arange(n)[:, None] + np.arange(k.size)[None, :] - r
    src = np.where(src < 0, -src - 1, src)
    src = np.where(src >= n, 2 * n - src - 1, src)
    blur_t = np.zeros((n, n))
    np.add.at(blur_t, (src.ravel(), np.repeat(np.arange(n), k.size)), np.tile(k, n))
    coords = np.arange(m, dtype=np.float64) / nu
    x0 = np.floor(coords).astype(np.int64)
    out = np.zeros((n, m))
    for i, wt in enumerate(keys(torch.from_numpy(coords - x0))):
        out += blur_t[:, np.clip(x0 + i - 1, 0, n - 1)] * wt.numpy()
    return out


def grid_rows(p: torch.Tensor, t: str, y0: int, y1: int, w: int):
    """align_ref.grid's coordinates of the frame's rows y0 .. y1 - 1."""
    m = params_to_matrix(p, t)[..., None, None]
    x = torch.arange(w, dtype=p.dtype, device=p.device)
    y = torch.arange(y0, y1, dtype=p.dtype, device=p.device)[:, None]

    def row(r):
        return m[..., r, 0, :, :] * x + m[..., r, 1, :, :] * y + m[..., r, 2, :, :]

    gx, gy = row(0), row(1)
    if t == "HOMOGRAPHY":
        d = row(2)
        gx, gy = gx / d, gy / d
    return gx, gy


def sample(image: torch.Tensor, pair: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
           dtype) -> torch.Tensor:
    """align_ref.bicubic of image[pair] ([B, H, W, C], any dtype) at gx, gy
    [R, h, w], in `dtype`, without copying the image per row."""
    b, hh, ww, c = image.shape
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = keys(gx - x0), keys(gy - y0)
    x0 = x0.nan_to_num(0.0).clamp(-4, ww + 3).long()
    y0 = y0.nan_to_num(0.0).clamp(-4, hh + 3).long()
    flat = image.reshape(b * hh * ww, c)
    base = (pair * (hh * ww))[:, None, None]
    out = torch.zeros((*gx.shape, c), dtype=dtype, device=gx.device)
    for j in range(4):
        yj = (y0 + (j - 1)).clamp(0, hh - 1) * ww + base
        for i in range(4):
            tap = flat[yj + (x0 + (i - 1)).clamp(0, ww - 1)].to(dtype)
            out += tap * (wy[j] * wx[i])[..., None]
    return out


def zoom(image: torch.Tensor, nu: float, dtype, band_px: int) -> torch.Tensor:
    """align_ref.pyramid's next level of `image` ([B, H, W, C], any dtype):
    the product over rows summed band by band."""
    b, h, w, c = image.shape
    hh, ww = int(h * nu + 0.5), int(w * nu + 0.5)
    my = torch.as_tensor(zoom_operator(h, hh, nu), dtype=dtype, device=image.device)
    mx = torch.as_tensor(zoom_operator(w, ww, nu), dtype=dtype, device=image.device)
    t = torch.zeros((b, w, c, hh), dtype=dtype, device=image.device)
    for y0, y1 in _bands(h, w * c, b, band_px):
        t += image[:, y0:y1].to(dtype).permute(0, 2, 3, 1) @ my[y0:y1]
    t = t.permute(0, 3, 2, 1) @ mx                           # [b, hh, c, ww]
    return t.permute(0, 1, 3, 2).contiguous()


def jacobian_rows(t: str, y0: int, y1: int, w: int, scale: torch.Tensor):
    """align_ref.jacobian's rows of pixels in frame rows y0 .. y1 - 1."""
    rows = y1 - y0
    x = torch.arange(w, dtype=scale.dtype, device=scale.device)[None, :].expand(rows, w)
    y = torch.arange(y0, y1, dtype=scale.dtype, device=scale.device)[:, None].expand(rows, w)
    x, y = x.reshape(-1), y.reshape(-1)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    cols = {
        "TRANSLATION": ([one, zero], [zero, one]),
        "EUCLIDEAN": ([one, zero, -y], [zero, one, x]),
        "SIMILARITY": ([one, zero, x, -y], [zero, one, y, x]),
        "AFFINITY": ([one, zero, x, y, zero, zero], [zero, one, zero, zero, x, y]),
        "HOMOGRAPHY": ([x, y, one, zero, zero, zero, -x * x, -x * y],
                       [zero, zero, zero, x, y, one, -x * y, -y * y]),
    }[t]
    pad = [zero] * (8 - len(cols[0]))
    return torch.stack(cols[0] + pad, -1) / scale, torch.stack(cols[1] + pad, -1) / scale


class Level:
    """One level's template in bands: for rows y0 .. y1 - 1, I1, its
    central gradients with the boundary band, their products and the
    Jacobian, each as align_ref.solve_level forms it over the whole frame."""

    def __init__(self, i1, cfg: dict, delta: int, scale: torch.Tensor, dtype):
        self.i1, self.cfg, self.delta, self.scale, self.dtype = i1, cfg, delta, scale, dtype

    def band(self, y0: int, y1: int):
        i1 = self.i1
        _, h, w, _ = i1.shape
        lo, hi = max(y0 - 1, 0), min(y1 + 1, h)
        ext = i1[:, lo:hi].to(self.dtype)
        img = ext[:, y0 - lo:y1 - lo]
        ix = torch.nn.functional.pad(0.5 * (img[:, :, 2:] - img[:, :, :-2]), (0, 0, 1, 1))
        iy = torch.zeros_like(img)
        a, e = max(y0, 1), min(y1, h - 1)
        if e > a:
            iy[:, a - y0:e - y0] = 0.5 * (ext[:, a + 1 - lo:e + 1 - lo]
                                          - ext[:, a - 1 - lo:e - 1 - lo])
        d = self.delta
        if self.cfg["nanifoutside"] and d > 0:
            band = torch.zeros((y1 - y0, w), dtype=img.dtype, device=img.device)
            r0, r1 = max(d, y0), min(h - d, y1)
            if r1 > r0:
                band[r0 - y0:r1 - y0, d:w - d] = 1.0
            ix, iy = ix * band[None, :, :, None], iy * band[None, :, :, None]
        g3 = ((ix * ix).sum(-1), (ix * iy).sum(-1), (iy * iy).sum(-1))
        jx, jy = jacobian_rows(self.cfg["transform"], y0, y1, w, self.scale)
        return img, ix, iy, g3, jx, jy


def _normal_system(lev: Level, i2, rows: Rows, idx, loss: str, h_quad, band_px: int):
    """(H [R, 8, 8], b [R, 8]) of the rows `idx` at their p and lambda,
    summed over bands of rows."""
    cfg, dt = lev.cfg, lev.dtype
    t = cfg["transform"]
    _, h, w, _ = lev.i1.shape
    pair, n = rows.pair[idx], len(idx)
    hm = torch.zeros((n, 8, 8), dtype=dt, device=i2.device)
    b = torch.zeros((n, 8), dtype=dt, device=i2.device)
    for y0, y1 in _bands(h, w, n, band_px):
        img, ix, iy, g3, jx, jy = lev.band(y0, y1)
        gx, gy = grid_rows(rows.p[idx], t, y0, y1, w)
        iw = sample(i2, pair, gx, gy, dt)
        valid = in_domain(gx, gy, h, w, lev.delta)[..., None]
        if cfg["nanifoutside"]:
            di = (iw - img[pair]) * valid.to(iw.dtype)
        else:
            di = torch.where(valid, iw, torch.zeros_like(iw)) - img[pair]
        u = (ix[pair] * di).sum(-1).reshape(n, -1)
        v = (iy[pair] * di).sum(-1).reshape(n, -1)
        if h_quad is not None:
            b += u @ jx + v @ jy
            continue
        wt = rho_prime((di * di).sum(-1), rows.lam[idx][:, None, None], loss).reshape(n, -1)
        gxx, gxy, gyy = (g[pair].reshape(n, -1) * wt for g in g3)
        hm += _hessian(gxx, gxy, gyy, jx, jy)
        b += (u * wt) @ jx + (v * wt) @ jy
    return (h_quad[rows.pair[idx]] if h_quad is not None else hm), b


def _quadratic_hessian(lev: Level, band_px: int) -> torch.Tensor:
    """[B, 8, 8]: the unweighted Hessian of every pair, summed over bands."""
    bsz, h, w, _ = lev.i1.shape
    out = torch.zeros((bsz, 8, 8), dtype=lev.dtype, device=lev.i1.device)
    for y0, y1 in _bands(h, w, 1, band_px):
        _, _, _, g3, jx, jy = lev.band(y0, y1)
        for k in range(bsz):
            out[k] += _hessian(*(g[k:k + 1].reshape(1, -1) for g in g3), jx, jy)[0]
    return out


def solve_level(i1, i2, rows: Rows, cfg: dict, fork_rel: float, max_rows: int, dtype,
                band_px: int = BAND_PX) -> Rows:
    """align_ref.solve_level, its normal equations summed over bands."""
    t, loss = cfg["transform"], cfg["robust"]
    _, h, w, _ = i1.shape
    delta = int(cfg["delta"])
    if cfg.get("delta_cap", True):
        delta = min(delta, max(0, (min(h, w) - 1) // 4))
    s = torch.as_tensor(preconditioner(t, h, w), dtype=dtype, device=i1.device)
    lev = Level(i1, cfg, delta, s, dtype)
    robust = loss != "QUADRATIC"
    h_quad = None if robust else _quadratic_hessian(lev, band_px)
    live = torch.zeros(8, dtype=dtype, device=i1.device)
    live[:NPARAMS[t]] = 1.0
    lam_fixed = float(cfg["lam"])
    anneal = robust and lam_fixed <= 0
    p0 = rows.p.clone()
    rows.lam = torch.full_like(rows.err, lam_fixed if lam_fixed > 0 else LAMBDA_0)
    rows.err = torch.full_like(rows.err, 1e10)
    rows.niters = torch.zeros_like(rows.niters)
    active = torch.ones_like(rows.diverged)
    start = torch.arange(len(rows.pair), device=i1.device)   # each row's p0 index

    for it in range(int(cfg["max_iter"])):
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        hm, b = _normal_system(lev, i2, rows, idx, loss, h_quad, band_px)
        chol, info = torch.linalg.cholesky_ex(hm + torch.diag(1.0 - live))
        dp = torch.cholesky_solve(b[..., None], chol)[..., 0] / s
        ok = (info == 0) & torch.isfinite(dp).all(-1)
        dp = torch.where(ok[:, None], dp, torch.zeros_like(dp)) * live
        err = torch.linalg.vector_norm(dp, dim=-1)
        p_new = compose_inverse(rows.p[idx], dp, t)
        bad = torch.zeros_like(ok)
        if cfg.get("divergence_guard", True):
            bad = _lost_overlap(p_new, t, h, w)
            p_new = torch.where(bad[:, None], p0[start[idx]], p_new)
        if anneal:
            lam = rows.lam[idx]
            rows.lam[idx] = torch.where(lam > LAMBDA_N, torch.clamp(lam * LAMBDA_RATIO, min=LAMBDA_N),
                                        lam)
        rows.p[idx], rows.err[idx] = p_new, err
        rows.niters[idx] += 1
        rows.diverged[idx] |= bad
        still = (err > cfg["tol"]) & ~bad
        last = it + 1 >= int(cfg["max_iter"])
        if last:
            still = torch.zeros_like(still)
        active[idx] = still
        near = ~bad & ((err - cfg["tol"]).abs() <= fork_rel * cfg["tol"])
        if not last and bool(near.any()):
            counts = torch.bincount(rows.pair, minlength=int(rows.pair.max()) + 1)
            fork = idx[near & (counts[rows.pair[idx]] < max_rows)]
            if fork.numel():
                rows = rows.cat(rows.take(fork))
                active = torch.cat([active, ~active[fork]])
                start = torch.cat([start, start[fork]])
    return rows


def align_ref(i1, i2, cfg: dict, dtype=torch.float64, fork_rel: float = 1e-2,
              max_rows: int = 8, band_px: int = BAND_PX) -> RefResult:
    """align_ref.align_ref in bands (module docstring): pairs i1, i2 ([B, H,
    W, C], any real dtype, 0..255) aligned with the configuration `cfg`,
    computing in `dtype`; warm start p = 0. iw and di come back in float32."""
    t = cfg["transform"]
    b, h, w, _ = i1.shape
    nscales, nu = int(cfg["nscales"]), float(cfg["nu"])
    shapes = level_shapes(h, w, nscales, nu)
    p1, p2 = [i1], [i2]
    for _ in range(1, nscales):
        p1.append(zoom(p1[-1], nu, dtype, band_px))
        p2.append(zoom(p2[-1], nu, dtype, band_px))
    dev = i1.device
    rows = Rows(pair=torch.arange(b, device=dev), p=torch.zeros((b, 8), dtype=dtype, device=dev),
                lam=torch.zeros(b, dtype=dtype, device=dev), err=torch.zeros(b, dtype=dtype, device=dev),
                niters=torch.zeros(b, dtype=torch.int64, device=dev),
                diverged=torch.zeros(b, dtype=torch.bool, device=dev))
    for s in range(nscales - 1, -1, -1):
        rows.diverged = torch.zeros_like(rows.diverged)
        rows = solve_level(p1[s], p2[s], rows, cfg, fork_rel, max_rows, dtype, band_px)
        if s > 0:
            (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
            rows.p = zoom_in(rows.p, t, cw, ch, fw, fh)
    del p1[1:], p2[1:]
    r, c = len(rows.pair), i1.shape[-1]
    out = RefResult(pair=rows.pair, p=rows.p, niters=rows.niters, diverged=rows.diverged,
                    iw=torch.empty((r, h, w, c), dtype=torch.float32, device=dev),
                    di=torch.empty((r, h, w, c), dtype=torch.float32, device=dev),
                    valid=torch.empty((r, h, w), dtype=torch.bool, device=dev))
    fill = float("nan") if cfg["nanifoutside"] else 0.0
    for y0, y1 in _bands(h, w, r, band_px):
        gx, gy = grid_rows(rows.p, t, y0, y1, w)
        iw = sample(i2, rows.pair, gx, gy, dtype)
        valid = in_domain(gx, gy, h, w, int(cfg["delta"]))
        iw = torch.where(valid[..., None], iw, torch.full_like(iw, fill))
        out.iw[:, y0:y1] = iw
        out.di[:, y0:y1] = iw - i1[rows.pair, y0:y1].to(dtype)
        out.valid[:, y0:y1] = valid
    return out
