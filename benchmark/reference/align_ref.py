"""Plain reference of `align`: the pyramidal inverse compositional algorithm
with robust IRLS, in plain PyTorch and float64 by default.

It follows the IPOL articles 2016.153 / 2018.222 and their reference code
(pyramid of Gaussian presmoothing and Keys bicubic resampling, central
gradients with the modified algorithm's boundary band, Gauss-Newton on the
preconditioned normal equations, lambda annealing 80 -> 5 by 0.9, the
divergence guard), written from those semantics for the benchmark: it
imports nothing of the program under test and takes nothing it made.

A solver stops a pair when ||dp|| <= tol. Two correct implementations that
round differently can take that decision differently when ||dp|| lies
within rounding of tol, and then end one step apart. So the reference
keeps both answers wherever ||dp|| lies within `fork_rel` of tol: a pair
then has more than one candidate row, and an answer is judged against the
nearest candidate. Rows per pair are capped at `max_rows`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

NPARAMS = {"TRANSLATION": 2, "EUCLIDEAN": 3, "SIMILARITY": 4, "AFFINITY": 6, "HOMOGRAPHY": 8}
LAMBDA_0, LAMBDA_N, LAMBDA_RATIO = 80.0, 5.0, 0.9
ZOOM_SIGMA_ZERO = 0.6
GUARD = 1e-10


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


class Arith:
    """How the reference rounds. The default rounds nothing beyond its
    dtype; `tf32_values` gives the products over pixels (the pyramid's and
    the normal equations') TF32 operands, as tensor cores do, and holds
    every image, level, gradient, sample and weight plane at TF32's
    precision (coordinates stay float32). The benchmark's own runs use the
    default; `tf32_values` is the control of benchmark/control.py."""

    def __init__(self, mode: str | None = None):
        if mode not in (None, "tf32_values"):
            raise ValueError(f"unknown rounding {mode!r}")
        self.tf32 = mode == "tf32_values"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return tf32(a) @ tf32(b) if self.tf32 else a @ b

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) if self.tf32 else x


FULL = Arith()


# ---------------------------------------------------------------------------
# Motion models: [..., 8] padded parameters and 3x3 matrices

def params_to_matrix(p: torch.Tensor, t: str) -> torch.Tensor:
    one, zero = torch.ones_like(p[..., 0]), torch.zeros_like(p[..., 0])
    tx, ty = p[..., 0], p[..., 1]
    if t == "TRANSLATION":
        rows = [one, zero, tx, zero, one, ty, zero, zero, one]
    elif t == "EUCLIDEAN":
        c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
        rows = [c, -s, tx, s, c, ty, zero, zero, one]
    elif t == "SIMILARITY":
        a, b = p[..., 2], p[..., 3]
        rows = [one + a, -b, tx, b, one + a, ty, zero, zero, one]
    elif t == "AFFINITY":
        rows = [one + p[..., 2], p[..., 3], tx, p[..., 4], one + p[..., 5], ty, zero, zero, one]
    elif t == "HOMOGRAPHY":
        rows = [one + p[..., 0], p[..., 1], p[..., 2], p[..., 3], one + p[..., 4], p[..., 5],
                p[..., 6], p[..., 7], one]
    else:
        raise ValueError(f"unknown motion model {t!r}")
    return torch.stack(rows, -1).reshape(*p.shape[:-1], 3, 3)


def matrix_to_params(m: torch.Tensor, t: str) -> torch.Tensor:
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    if t == "TRANSLATION":
        cols = [tx, ty]
    elif t == "EUCLIDEAN":
        cols = [tx, ty, torch.atan2(m[..., 1, 0], m[..., 0, 0])]
    elif t == "SIMILARITY":
        cols = [tx, ty, m[..., 0, 0] - 1, m[..., 1, 0]]
    elif t == "AFFINITY":
        cols = [tx, ty, m[..., 0, 0] - 1, m[..., 0, 1], m[..., 1, 0], m[..., 1, 1] - 1]
    else:
        cols = [m[..., 0, 0] - 1, m[..., 0, 1], m[..., 0, 2], m[..., 1, 0], m[..., 1, 1] - 1,
                m[..., 1, 2], m[..., 2, 0], m[..., 2, 1]]
    out = torch.stack(cols, -1)
    return torch.nn.functional.pad(out, (0, 8 - out.shape[-1]))


def adjugate3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d], -1)
    return adj.reshape(*m.shape[:-2], 3, 3)


def compose_inverse(p: torch.Tensor, dp: torch.Tensor, t: str) -> torch.Tensor:
    """p <- p o dp^-1; an update whose homogeneous scale squared is <= 1e-10
    leaves p unchanged (the reference's det guards)."""
    if t == "TRANSLATION":
        out = p.clone()
        out[..., :2] = p[..., :2] - dp[..., :2]
        return out
    u = params_to_matrix(p, t) @ adjugate3(params_to_matrix(dp, t))
    w = u[..., 2, 2]
    ok = w * w > GUARD
    new = matrix_to_params(u / torch.where(ok, w, torch.ones_like(w))[..., None, None], t)
    return torch.where(ok[..., None], new, p)


def map_points(p: torch.Tensor, t: str, xs: torch.Tensor, ys: torch.Tensor):
    """x'(x; p) of points (xs, ys) that broadcast against p[..., None]."""
    m = params_to_matrix(p, t)

    def row(r):
        return m[..., r, 0, None] * xs + m[..., r, 1, None] * ys + m[..., r, 2, None]

    gx, gy = row(0), row(1)
    if t == "HOMOGRAPHY":
        d = row(2)
        gx, gy = gx / d, gy / d
    return gx, gy


def grid(p: torch.Tensor, t: str, h: int, w: int):
    """Sampling coordinates x'(x; p) of every pixel: each [B, h, w]."""
    m = params_to_matrix(p, t)[..., None, None]
    x = torch.arange(w, dtype=p.dtype, device=p.device)
    y = torch.arange(h, dtype=p.dtype, device=p.device)[:, None]

    def row(r):
        return m[..., r, 0, :, :] * x + m[..., r, 1, :, :] * y + m[..., r, 2, :, :]

    gx, gy = row(0), row(1)
    if t == "HOMOGRAPHY":
        d = row(2)
        gx, gy = gx / d, gy / d
    return gx, gy


def corner_gap_px(p: torch.Tensor, q: torch.Tensor, t: str, h: int, w: int) -> torch.Tensor:
    """Largest distance in pixels between the frame's four corners mapped
    by p and by q ([..., 8] each), in float64."""
    xs = torch.tensor([0.0, w - 1.0, 0.0, w - 1.0], dtype=torch.float64, device=p.device)
    ys = torch.tensor([0.0, 0.0, h - 1.0, h - 1.0], dtype=torch.float64, device=p.device)
    ax, ay = map_points(p.double(), t, xs, ys)
    bx, by = map_points(q.double(), t, xs, ys)
    return torch.hypot(ax - bx, ay - by).amax(-1)


def jacobian(t: str, h: int, w: int, scale: np.ndarray, dtype, device):
    """dW/dp at p = 0 with its columns divided by `scale`: (jx, jy), [h*w, 8]."""
    x = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w).reshape(-1)
    y = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w).reshape(-1)
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
    s = torch.as_tensor(scale, dtype=dtype, device=device)
    return torch.stack(cols[0] + pad, -1) / s, torch.stack(cols[1] + pad, -1) / s


def preconditioner(t: str, h: int, w: int) -> np.ndarray:
    """Hartley column scales: linear columns by L = max(h, w), projective by L^2."""
    big = float(max(h, w))
    s = np.ones(8)
    if t == "EUCLIDEAN":
        s[2] = big
    elif t == "SIMILARITY":
        s[2:4] = big
    elif t == "AFFINITY":
        s[2:6] = big
    elif t == "HOMOGRAPHY":
        s[[0, 1, 3, 4]] = big
        s[[6, 7]] = big * big
    return s


def zoom_in(p: torch.Tensor, t: str, nx: int, ny: int, nxx: int, nyy: int) -> torch.Tensor:
    """Rescale parameters from a (nx, ny) level to (nxx, nyy)."""
    nu = max(nxx / nx, nyy / ny)
    s = np.ones(8)
    if t == "HOMOGRAPHY":
        s[[2, 5]] = nu
        s[[6, 7]] = 1.0 / nu
    else:
        s[[0, 1]] = nu
    return p * torch.as_tensor(s, dtype=p.dtype, device=p.device)


# ---------------------------------------------------------------------------
# Sampling

def keys(t: torch.Tensor):
    """Keys cubic (a = -0.5) weights of the taps floor-1 .. floor+2."""
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)


def bicubic(image: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Sample image [B, H, W, C] at gx, gy [B, h, w] with taps clipped to
    the edges; a non-finite coordinate gives NaN."""
    b, hh, ww, c = image.shape
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = keys(gx - x0), keys(gy - y0)
    x0 = x0.nan_to_num(0.0).clamp(-4, ww + 3).long()
    y0 = y0.nan_to_num(0.0).clamp(-4, hh + 3).long()
    flat = image.reshape(b, hh * ww, c)
    out = torch.zeros((*gx.shape, c), dtype=image.dtype, device=image.device)
    for j in range(4):
        yj = (y0 + (j - 1)).clamp(0, hh - 1) * ww
        for i in range(4):
            idx = (yj + (x0 + (i - 1)).clamp(0, ww - 1)).reshape(b, -1, 1).expand(-1, -1, c)
            out += torch.gather(flat, 1, idx).reshape(out.shape) * (wy[j] * wx[i])[..., None]
    return out


def in_domain(gx, gy, h: int, w: int, delta: int) -> torch.Tensor:
    d = float(delta)
    return (gx >= d) & (gx <= w - 1 - d) & (gy >= d) & (gy <= h - 1 - d)


# ---------------------------------------------------------------------------
# Pyramid: per level a Gaussian presmoothing and a bicubic resample at o / nu

def level_shapes(h: int, w: int, nscales: int, nu: float):
    shapes = [(h, w)]
    for _ in range(1, nscales):
        hh, ww = shapes[-1]
        shapes.append((int(hh * nu + 0.5), int(ww * nu + 0.5)))
    return shapes


def _gauss(sigma: float) -> np.ndarray:
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@lru_cache(maxsize=None)
def zoom_operator(n: int, m: int, nu: float) -> np.ndarray:
    """[n, m] float64: blur with mirror-repeat boundary, then Keys
    resampling at i / nu with taps clipped to the edges."""
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (nu * nu) - 1.0)
    k = _gauss(sigma)
    r = (k.size - 1) // 2
    blur = np.zeros((n, n))
    for i in range(n):
        for j, kv in enumerate(k):
            src = i + j - r
            src = -src - 1 if src < 0 else src
            src = 2 * n - src - 1 if src >= n else src
            blur[i, src] += kv
    coords = np.arange(m, dtype=np.float64) / nu
    x0 = np.floor(coords).astype(np.int64)
    ws = keys(torch.from_numpy(coords - x0))
    res = np.zeros((n, m))
    for i, wt in enumerate(ws):
        np.add.at(res, (np.clip(x0 + i - 1, 0, n - 1), np.arange(m)), wt.numpy())
    return blur.T @ res


def pyramid(image: torch.Tensor, nscales: int, nu: float, ar: Arith = FULL) -> list[torch.Tensor]:
    levels = [image]
    for _ in range(1, nscales):
        _, h, w, _ = levels[-1].shape
        hh, ww = int(h * nu + 0.5), int(w * nu + 0.5)
        my = torch.as_tensor(zoom_operator(h, hh, nu), dtype=image.dtype, device=image.device)
        mx = torch.as_tensor(zoom_operator(w, ww, nu), dtype=image.dtype, device=image.device)
        t = ar.mm(levels[-1].permute(0, 2, 3, 1), my)            # [b, w, c, y]
        t = ar.mm(t.permute(0, 3, 2, 1), mx)                     # [b, y, c, x]
        levels.append(ar.keep(t.permute(0, 1, 3, 2).contiguous()))
    return levels


# ---------------------------------------------------------------------------
# One level's Gauss-Newton loop

def rho_prime(t2: torch.Tensor, lam: torch.Tensor, loss: str) -> torch.Tensor:
    lam2 = lam * lam
    if loss == "QUADRATIC":
        return torch.ones_like(t2)
    if loss == "TRUNCATED_QUADRATIC":
        return (t2 < lam2).to(t2.dtype)
    if loss == "GERMAN_MCCLURE":
        return lam2 / (lam2 + t2) ** 2
    if loss == "LORENTZIAN":
        return 1.0 / (lam2 + t2)
    if loss == "CHARBONNIER":
        return 1.0 / torch.sqrt(t2 + lam2)
    raise ValueError(f"unknown loss {loss!r}")


@dataclass
class Rows:
    """Candidate rows: `pair` is the row's pair; p, lam, err, niters and
    diverged are its state."""

    pair: torch.Tensor
    p: torch.Tensor
    lam: torch.Tensor
    err: torch.Tensor
    niters: torch.Tensor
    diverged: torch.Tensor

    def take(self, idx: torch.Tensor) -> "Rows":
        return Rows(*(getattr(self, f)[idx] for f in self.__dataclass_fields__))

    def cat(self, other: "Rows") -> "Rows":
        return Rows(*(torch.cat([getattr(self, f), getattr(other, f)])
                      for f in self.__dataclass_fields__))


def _normal_system(t2_fn, i1, i2, ix, iy, g3, jx, jy, h_quad, rows, idx, cfg, delta, ar):
    """(H [R, 8, 8], b [R, 8]) of the rows `idx` at their p and lambda."""
    pair = rows.pair[idx]
    _, h, w, _ = i1.shape
    gx, gy = grid(rows.p[idx], cfg["transform"], h, w)
    iw = ar.keep(bicubic(i2[pair], gx, gy))
    valid = in_domain(gx, gy, h, w, delta)[..., None]
    if cfg["nanifoutside"]:
        di = (iw - i1[pair]) * valid.to(iw.dtype)
    else:
        di = torch.where(valid, iw, torch.zeros_like(iw)) - i1[pair]
    di = ar.keep(di)
    u = ar.keep((ix[pair] * di).sum(-1).reshape(len(idx), -1))
    v = ar.keep((iy[pair] * di).sum(-1).reshape(len(idx), -1))
    if h_quad is not None:
        return h_quad[pair], ar.mm(u, jx) + ar.mm(v, jy)
    wt = ar.keep(t2_fn((di * di).sum(-1), rows.lam[idx][:, None, None]).reshape(len(idx), -1))
    gxx, gxy, gyy = (ar.keep(g[pair].reshape(len(idx), -1) * wt) for g in g3)
    return (_hessian(gxx, gxy, gyy, jx, jy, ar),
            ar.mm(ar.keep(u * wt), jx) + ar.mm(ar.keep(v * wt), jy))


def _hessian(gxx, gxy, gyy, jx, jy, ar: Arith = FULL, chunk: int = 1 << 18) -> torch.Tensor:
    """sum_p gxx JxJx^T + gxy (JxJy^T + JyJx^T) + gyy JyJy^T, per row."""
    out = torch.zeros((gxx.shape[0], 64), dtype=gxx.dtype, device=gxx.device)
    for s in range(0, jx.shape[0], chunk):
        a, b = jx[s:s + chunk], jy[s:s + chunk]
        xx = (a[:, :, None] * a[:, None, :]).reshape(-1, 64)
        xy = (a[:, :, None] * b[:, None, :]).reshape(-1, 64)
        yy = (b[:, :, None] * b[:, None, :]).reshape(-1, 64)
        sym = xy + xy.reshape(-1, 8, 8).transpose(1, 2).reshape(-1, 64)
        out += ar.mm(gxx[:, s:s + chunk], xx) + ar.mm(gyy[:, s:s + chunk], yy)
        out += ar.mm(gxy[:, s:s + chunk], sym)
    return out.reshape(-1, 8, 8)


def solve_level(i1, i2, rows: Rows, cfg: dict, fork_rel: float, max_rows: int,
                ar: Arith = FULL) -> Rows:
    """Run one level's loop on every row; rows may fork (module docstring)."""
    t, loss = cfg["transform"], cfg["robust"]
    _, h, w, _ = i1.shape
    delta = int(cfg["delta"])
    if cfg.get("delta_cap", True):
        delta = min(delta, max(0, (min(h, w) - 1) // 4))
    ix = torch.nn.functional.pad(0.5 * (i1[:, :, 2:] - i1[:, :, :-2]), (0, 0, 1, 1))
    iy = torch.nn.functional.pad(0.5 * (i1[:, 2:] - i1[:, :-2]), (0, 0, 0, 0, 1, 1))
    if cfg["nanifoutside"] and delta > 0:
        band = torch.zeros((h, w), dtype=i1.dtype, device=i1.device)
        band[delta:h - delta, delta:w - delta] = 1.0
        ix, iy = ix * band[None, :, :, None], iy * band[None, :, :, None]
    ix, iy = ar.keep(ix), ar.keep(iy)
    g3 = tuple(ar.keep(g) for g in ((ix * ix).sum(-1), (ix * iy).sum(-1), (iy * iy).sum(-1)))
    scale = preconditioner(t, h, w)
    jx, jy = (ar.keep(j) for j in jacobian(t, h, w, scale, i1.dtype, i1.device))
    robust = loss != "QUADRATIC"
    h_quad = None if robust else torch.stack([_hessian(*(g[k:k + 1].reshape(1, -1) for g in g3),
                                                       jx, jy, ar)[0]
                                              for k in range(i1.shape[0])])
    live = torch.zeros(8, dtype=i1.dtype, device=i1.device)
    live[:NPARAMS[t]] = 1.0
    s = torch.as_tensor(scale, dtype=i1.dtype, device=i1.device)
    lam_fixed = float(cfg["lam"])
    anneal = robust and lam_fixed <= 0
    p0 = rows.p.clone()
    rows.lam = torch.full_like(rows.err, lam_fixed if lam_fixed > 0 else LAMBDA_0)
    rows.err = torch.full_like(rows.err, 1e10)
    rows.niters = torch.zeros_like(rows.niters)
    active = torch.ones_like(rows.diverged)
    start = torch.arange(len(rows.pair), device=i1.device)   # each row's p0 index

    def t2_fn(t2, lam):
        return rho_prime(t2, lam, loss)

    for it in range(int(cfg["max_iter"])):
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        hm, b = _normal_system(t2_fn, i1, i2, ix, iy, g3, jx, jy, h_quad, rows, idx, cfg, delta,
                               ar)
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


def _lost_overlap(p, t: str, h: int, w: int, margin: float = 0.5) -> torch.Tensor:
    xs = torch.tensor([0.0, w - 1.0, 0.0, w - 1.0, (w - 1) / 2.0], dtype=p.dtype, device=p.device)
    ys = torch.tensor([0.0, 0.0, h - 1.0, h - 1.0, (h - 1) / 2.0], dtype=p.dtype, device=p.device)
    gx, gy = map_points(p, t, xs, ys)
    mx, my = margin * w, margin * h
    ok = ((gx >= -mx) & (gx <= w - 1 + mx) & (gy >= -my) & (gy <= h - 1 + my)
          & torch.isfinite(gx) & torch.isfinite(gy))
    return ~ok.any(-1) | ~torch.isfinite(p).all(-1)


# ---------------------------------------------------------------------------
# The whole call

@dataclass
class RefResult:
    """Candidate rows of every pair (`pair` maps a row to its pair) and the
    final warp of each row: iw (NaN or 0 outside per nanifoutside), di and
    valid, each [R, H, W(, C)]."""

    pair: torch.Tensor
    p: torch.Tensor
    niters: torch.Tensor
    diverged: torch.Tensor
    iw: torch.Tensor | None = None
    di: torch.Tensor | None = None
    valid: torch.Tensor | None = None


def align_ref(i1, i2, cfg: dict, dtype=torch.float64, fork_rel: float = 1e-2,
              max_rows: int = 8, warp: bool = True, rounding: str | None = None) -> RefResult:
    """Align pairs i1, i2 ([B, H, W, C], any real dtype, 0..255) as `align`
    does with the configuration `cfg` (the benchmark's configuration dict),
    computing in `dtype` with `rounding` (see Arith); warm start p = 0."""
    ar = Arith(rounding)
    t = cfg["transform"]
    i1, i2 = i1.to(dtype), i2.to(dtype)
    b, h, w, _ = i1.shape
    nscales, nu = int(cfg["nscales"]), float(cfg["nu"])
    shapes = level_shapes(h, w, nscales, nu)
    p1, p2 = pyramid(i1, nscales, nu, ar), pyramid(i2, nscales, nu, ar)
    dev = i1.device
    rows = Rows(pair=torch.arange(b, device=dev), p=torch.zeros((b, 8), dtype=dtype, device=dev),
                lam=torch.zeros(b, dtype=dtype, device=dev), err=torch.zeros(b, dtype=dtype, device=dev),
                niters=torch.zeros(b, dtype=torch.int64, device=dev),
                diverged=torch.zeros(b, dtype=torch.bool, device=dev))
    for s in range(nscales - 1, -1, -1):
        rows.diverged = torch.zeros_like(rows.diverged)
        rows = solve_level(p1[s], p2[s], rows, cfg, fork_rel, max_rows, ar)
        if s > 0:
            (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
            rows.p = zoom_in(rows.p, t, cw, ch, fw, fh)
    out = RefResult(pair=rows.pair, p=rows.p, niters=rows.niters, diverged=rows.diverged)
    if warp:
        gx, gy = grid(rows.p, t, h, w)
        iw = ar.keep(bicubic(i2[rows.pair], gx, gy))
        valid = in_domain(gx, gy, h, w, int(cfg["delta"]))
        fill = float("nan") if cfg["nanifoutside"] else 0.0
        out.iw = torch.where(valid[..., None], iw, torch.full_like(iw, fill))
        out.di = out.iw - i1[rows.pair]
        out.valid = valid
    return out
