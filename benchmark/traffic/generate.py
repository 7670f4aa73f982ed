"""The one traffic generator: a mix file of parameters in, a pool of pair
batches on the device out.

A mix (`<name>.json` beside this file) states:

- `kind`: "bulk" (independent pairs) or "clip" (consecutive frames of one
  clip, B + 1 frames for B pairs);
- `batch`, `height`, `width`, `channels`: the shape of one `align` call;
- `pool`: how many distinct batches a run builds; the window cycles them;
- `hard_share`: the exact share of hard motions in every batch; only the
  positions of the hard pairs are drawn;
- `easy`, `hard`: `translation_px` and `linear_over_l` (linear parts over
  L = max(H, W)); `projective_over_l2` for a homography's last row. These
  are the draws of the JAX bench's `make_bench_batch`;
- `octaves`: Gaussian scales (px) of the blurred-noise content, each
  normalised to unit spread before the sum;
- `margin_px`: content beyond the frame that motions may reach;
- `noise_sigma`: the sensor noise of every frame, in grey levels, before
  the frames are quantised to uint8 as a decoder hands them over;
- `check_pairs`: pairs per batch that the correctness check samples;
- `pool_seed`: the seed the pool's scenes, motions and sensor noise are
  drawn from. The run's seed orders the pairs inside each batch; the
  batches keep their order, so that the window and the warm-up call the
  same batches in the same sequence in every run.

Why the pool does not come from the run's seed: the program runs a call
until its slowest pair converges, and at the two coarsest levels a rare
pair, easy or hard, takes all 30 iterations; whether a batch of 1024 holds
one swings a call's trips by up to 20 (26 or 47; 57 or 77), and its time
with them. Drawn from the run's seed, the work of a run followed the seed.
So every seed gets the same pairs, in its own order. Nor does the seed pick
the batch a window starts on: where one batch takes twice the trips of
the others, that decided whether a window held one call of it more.

Bulk pairs: I2 is a crop of the batch's canvas at a seeded offset and I1 the
canvas sampled at the crop's points moved by the pair's motion, so that
I1(x) = I2(x'(x; p)). Clips: frame k is the canvas seen through pose P_k,
P_{k+1} = P_k M(p_k), so pair k (I1 = frame k+1, I2 = frame k) has motion
p_k; a drawn motion whose pose would leave the canvas is taken with the
opposite sign. Every frame gets its own sensor noise.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..reference.align_ref import bicubic, params_to_matrix

HERE = Path(__file__).resolve().parent
KINDS = ("bulk", "clip")


def load_mix(name: str) -> dict:
    mix = json.loads((HERE / f"{name}.json").read_text())
    if mix["kind"] not in KINDS:
        raise ValueError(f"traffic {name!r}: unknown kind {mix['kind']!r}")
    return mix


@dataclass
class Batch:
    """One `align` call's inputs (uint8 [B, H, W, C] on the device), the
    motions that made them ([B, 8] float64) and which pairs are hard."""

    i1: torch.Tensor
    i2: torch.Tensor
    motion: np.ndarray
    hard: np.ndarray


def _seeds(seed: int, n: int) -> list[int]:
    """n independent 63-bit seeds from the run's seed (any integer)."""
    ss = np.random.SeedSequence(seed % (1 << 64))
    return [int(s.generate_state(2, np.uint64)[0] >> np.uint64(1)) for s in ss.spawn(n)]


def draw_motions(rng: np.random.Generator, n: int, transform: str, h: int, w: int,
                 mix: dict) -> tuple[np.ndarray, np.ndarray]:
    """([n, 8] padded motions, [n] hard flags): exactly round(hard_share * n)
    hard motions at drawn positions, the rest easy."""
    nhard = int(round(mix["hard_share"] * n))
    hard = np.zeros(n, bool)
    hard[rng.permutation(n)[:nhard]] = True
    big = float(max(h, w))
    tr = np.where(hard, mix["hard"]["translation_px"], mix["easy"]["translation_px"])
    lin = np.where(hard, mix["hard"]["linear_over_l"], mix["easy"]["linear_over_l"]) / big
    proj = mix["projective_over_l2"] / (big * big)

    def u(scale, k):
        return rng.uniform(-1.0, 1.0, (n, k)) * np.reshape(scale, (-1, 1))

    p = np.zeros((n, 8))
    if transform == "HOMOGRAPHY":
        p[:, [0, 1, 3, 4]] = u(lin, 4)
        p[:, [2, 5]] = u(tr, 2)
        p[:, 6:8] = u(np.full(n, proj), 2)
    else:
        p[:, :2] = u(tr, 2)
        k = {"TRANSLATION": 0, "EUCLIDEAN": 1, "SIMILARITY": 2, "AFFINITY": 4}[transform]
        p[:, 2:2 + k] = u(lin, k)
    return p, hard


def canvas(gen: torch.Generator, hc: int, wc: int, c: int, octaves, device) -> torch.Tensor:
    """[hc, wc, c] float32 content in 0..255: seeded noise blurred at each
    octave's scale (periodic Gaussian in the frequency domain), each octave
    normalised, summed, and set to mean 128 and spread 40."""
    fy = torch.fft.fftfreq(hc, device=device)[:, None]
    fx = torch.fft.rfftfreq(wc, device=device)[None, :]
    f2 = fy * fy + fx * fx
    total = torch.zeros((c, hc, wc), device=device)
    for sigma in octaves:
        noise = torch.rand((c, hc, wc), generator=gen, device=device)
        spec = torch.fft.rfft2(noise) * torch.exp(-2.0 * math.pi ** 2 * sigma ** 2 * f2)
        spec[:, 0, 0] = 0.0
        band = torch.fft.irfft2(spec, s=(hc, wc))
        total += band / band.std()
    total /= total.std()
    return (128.0 + 40.0 * total).clamp(0.0, 255.0).permute(1, 2, 0).contiguous()


def render(content: torch.Tensor, mats: torch.Tensor, h: int, w: int, chunk: int) -> torch.Tensor:
    """[n, h, w, c] float32: content sampled at mats [n, 3, 3] (frame pixel
    -> content point, homogeneous), Keys bicubic, `chunk` frames at a time."""
    hc, wc, c = content.shape
    x = torch.arange(w, dtype=torch.float64, device=content.device)
    y = torch.arange(h, dtype=torch.float64, device=content.device)[:, None]
    out = []
    for s in range(0, mats.shape[0], chunk):
        m = mats[s:s + chunk, :, :, None, None]
        gx = m[:, 0, 0] * x + m[:, 0, 1] * y + m[:, 0, 2]
        gy = m[:, 1, 0] * x + m[:, 1, 1] * y + m[:, 1, 2]
        d = m[:, 2, 0] * x + m[:, 2, 1] * y + m[:, 2, 2]
        src = content[None].expand(gx.shape[0], hc, wc, c)
        out.append(bicubic(src, (gx / d).float(), (gy / d).float()))
    return torch.cat(out)


def quantise(frames: torch.Tensor, gen: torch.Generator, sigma: float) -> torch.Tensor:
    """Add Gaussian sensor noise of `sigma` grey levels, round, clip, uint8."""
    noise = torch.randn(frames.shape, generator=gen, device=frames.device) * sigma
    return (frames + noise).round_().clamp_(0.0, 255.0).to(torch.uint8)


def _corners_inside(mat: np.ndarray, h: int, w: int, hc: int, wc: int) -> bool:
    pts = mat @ np.array([[0, w - 1, 0, w - 1], [0, 0, h - 1, h - 1], [1, 1, 1, 1]], float)
    x, y = pts[0] / pts[2], pts[1] / pts[2]
    return bool((x >= 2).all() and (x <= wc - 3).all() and (y >= 2).all() and (y <= hc - 3).all())


def _bulk(mix, transform, seed, device) -> Batch:
    b, h, w, c, m = mix["batch"], mix["height"], mix["width"], mix["channels"], mix["margin_px"]
    s_rng, s_canvas, s_noise = _seeds(seed, 3)
    rng = np.random.default_rng(s_rng)
    gen = torch.Generator(device=device).manual_seed(s_canvas)
    hc, wc = 3 * h, 3 * w
    content = canvas(gen, hc, wc, c, mix["octaves"], device)
    p, hard = draw_motions(rng, b, transform, h, w, mix)
    oy = rng.integers(m, hc - h - m, b)
    ox = rng.integers(m, wc - w - m, b)
    shift = np.tile(np.eye(3), (b, 1, 1))
    shift[:, 0, 2], shift[:, 1, 2] = ox, oy
    motion = params_to_matrix(torch.from_numpy(p), transform).numpy()
    mats = torch.from_numpy(np.concatenate([shift @ motion, shift])).to(device)
    frames = render(content, mats, h, w, mix["render_chunk"])
    gen.manual_seed(s_noise)
    frames = quantise(frames, gen, mix["noise_sigma"])
    return Batch(i1=frames[:b].contiguous(), i2=frames[b:].contiguous(), motion=p, hard=hard)


def _clip(mix, transform, seed, device) -> Batch:
    b, h, w, c, m = mix["batch"], mix["height"], mix["width"], mix["channels"], mix["margin_px"]
    s_rng, s_canvas, s_noise = _seeds(seed, 3)
    rng = np.random.default_rng(s_rng)
    gen = torch.Generator(device=device).manual_seed(s_canvas)
    hc, wc = h + 2 * m, w + 2 * m
    content = canvas(gen, hc, wc, c, mix["octaves"], device)
    p, hard = draw_motions(rng, b, transform, h, w, mix)
    pose = np.eye(3)
    pose[0, 2], pose[1, 2] = m, m
    poses = [pose]
    for k in range(b):
        for sign in (1.0, -1.0):
            step = params_to_matrix(torch.from_numpy(sign * p[k]), transform).numpy()
            if _corners_inside(poses[-1] @ step, h, w, hc, wc):
                p[k] *= sign
                break
        else:
            raise ValueError(f"clip motion {k} leaves the canvas: raise margin_px")
        poses.append(poses[-1] @ step)
    frames = render(content, torch.from_numpy(np.stack(poses)).to(device), h, w,
                    mix["render_chunk"])
    gen.manual_seed(s_noise)
    frames = quantise(frames, gen, mix["noise_sigma"])
    return Batch(i1=frames[1:].contiguous(), i2=frames[:-1].contiguous(), motion=p, hard=hard)


def make_pool(mix: dict, transform: str, seed: int, device) -> list[Batch]:
    """The mix's `pool` batches (from `pool_seed`), in their order, the pairs
    of each permuted by the run's `seed`."""
    make = _bulk if mix["kind"] == "bulk" else _clip
    pool = [make(mix, transform, s, device) for s in _seeds(mix["pool_seed"], mix["pool"])]
    rng = np.random.default_rng(_seeds(seed, 1)[0])
    out = []
    for b in pool:
        perm = rng.permutation(mix["batch"])
        idx = torch.from_numpy(perm).to(b.i1.device)
        out.append(Batch(i1=b.i1[idx], i2=b.i2[idx], motion=b.motion[perm], hard=b.hard[perm]))
    return out
