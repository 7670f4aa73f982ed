#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`inverse_compositional_algorithm_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA device and nvcc. It builds the kernels from the sources in
this checkout (failing on a register spill in the compiler's report),
holds each kernel (K1 fused iteration, K3 warp, K4 moments, K5 warp
floor, K1a, K1's ablation variants, K6, the solver trip's update at
batch 1024, robust HOMOGRAPHY and quadratic EUCLIDEAN, and at batch 1,
four-band AFFINITY LORENTZIAN, and K7, the level set-up, robust at the finest
level of 1024 584x388 pairs and on one whole four-band tile pair, quadratic
at the finest level of 64 1080p pairs) against its plain
PyTorch version at the flagship's shapes, and K1 and K3 also on a 69-degree rotation,
a diverged homography and one whole four-band 10980x10980 Sentinel-2 tile
pair (NaN positions equal, reruns bitwise equal; K1 too
on ragged and coarse frames, at batch 1 and 16 and at 1, 2 and 4
channels; K5 on both of its
load paths, TMA and plain, at ragged, gray, minimal and 4K frames), then
drives the port's entry points, each with the kernels' launch counts set
to 0 just before it and read just after:

- `align()` end to end on 8 synthetic 584x388 RGB pairs with known motion
  (HOMOGRAPHY + CHARBONNIER, lambda annealed 80 -> 5, 5 scales, then the
  default AlignConfig), held against the ground truth and the CPU path;
- `eval.benchmarks.run_benchmark()`, the full record (flagship, hard
  motion, fixed 30 iterations, K1 roofline, K5 floor, 720p/1080p/4K),
  printed on one line;
- `eval.profile_stages.profile_stages()`, the stage table;
- `eval.harness` sweeps on 16 procedural 256x256 contents: five motion
  models, and the robust losses against QUADRATIC on occluded pairs;
- the scale-out layer (`parallel/`): K1 and K3 on the row shards of the
  flagship batch and of one 3840x2160 pair (2 and 4 shards, each against
  its plain version; K1's sum against the whole frame's, K3's rows bit
  for bit the whole-frame warp's), `align_sharded(tile_rows=True)` as 2
  gloo ranks on the one card for the flagship batch and for one 3840x2160
  pair (held
  against the ground truth and single-card `align()`), and
  `align_sharded` and `parallel.launch.main` as one NCCL rank (and as
  NCCL ranks across cards, pairs x tile, where there are 2 or more); each
  rank's K1 and K3 launch counts add into the kernels line;
- K1's ablation variants (K1a, csrc/fused_iter_ablate.cu) against the
  production K1 on 2 flagship pairs at delta 10 (full, nomask and nofold
  bit for bit; the others finite, repeatable and different), then
  `eval.attr_bench.run()`, the cost attribution at batch 16, printed on
  an `attr_bench {...}` line; the stabilization walkthrough
  (examples/stabilize_torch.py) against its ground-truth jitter; and the
  reference-signature shims of `models.layers` (K1, K3, and K4 through
  the quadratic ones) against the ground truth.

It prints one JSON line with every kernel (launches summed over those
runs, CUDA-event time, device-only time from torch.profiler with the L2
warm and cold, plain time, bound, library time), the card's name and
power limit, and last a JSON
object with "ok": true. It exits non-zero, without that line, when there
is no CUDA device or any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np

B, H, W, C = 8, 388, 584, 3          # the flagship batch (eval/benchmarks.py:1-10)
COARSE = (25, 37)                    # its coarsest pyramid level
KERNEL_TOL = 2e-4                    # moments, normalized by max(|ref|, 1)
TRIP_TOL = 1e-5                      # K6's state, normalized by max(|ref|, 1)
TRIP_CORNER_TOL = 1e-3               # px, K6's p and motion matrices against the plain update
TRIP_FLOPS = 6000                    # K6's flops a pair: the assembly's ~5800, the 8x8 solve
WARP_TOL = 2e-3                      # warp of 0..255 images, absolute
CORNER_TOL_GT = 0.1                  # px, align against the ground truth
CORNER_TOL_CPU = 1e-2                # px, CUDA align against the CPU plain align
EVAL_N, EVAL_SIZE = 16, 256          # procedural contents of the eval phase
EVAL_MAE = 1e-3                      # clean pairs, every motion model
OCCL_MAE_ROBUST = 1e-2               # occluded pairs, every robust loss
OCCL_MAE_QUADRATIC = 0.1             # occluded pairs: QUADRATIC must exceed it
RANK_TIMEOUT = 300.0                 # s, every multi-rank run of phase 12


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import inverse_compositional_algorithm_tpu_torch as ica
    from inverse_compositional_algorithm_tpu_torch.ops import gradients, pyramid, warp
    from inverse_compositional_algorithm_tpu_torch.eval import (
        attr_bench, benchmarks, harness, profile_stages, run_eval,
    )
    from inverse_compositional_algorithm_tpu_torch.models import layers
    from inverse_compositional_algorithm_tpu_torch.ops.kernels import (
        _build, fused_iter as k1, level_pack as k7, normal_eq as k4, trip_update as k6,
        warp as k3, warp_floor as k5,
    )
    from inverse_compositional_algorithm_tpu_torch.ops.normal_equations import grad_moments
    from inverse_compositional_algorithm_tpu_torch.ops.transforms import (
        param_preconditioner, transform_points,
    )
    from inverse_compositional_algorithm_tpu_torch.parallel.ranks import drive, run_launch
    from inverse_compositional_algorithm_tpu_torch.parallel.spawn import run_ranks
    from inverse_compositional_algorithm_tpu_torch.utils.profiling import device_ms

    T, R = ica.TransformType, ica.RobustLoss
    dev = torch.device("cuda")
    card = benchmarks.card_info()["nvidia_smi"]     # name, power limit
    require(card is not None, "nvidia-smi is missing")
    log(f"phase 1 card: {card}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {build_s:.2f} s (nvcc {_build.BUILD_INFO['seconds']:.2f} s, "
        f"compiled={_build.BUILD_INFO['compiled']})")
    ptxas = _build.BUILD_INFO["log"]
    require("trip_update_kernel" in ptxas, "no compiler report of the library to check")
    func = ""
    for line in ptxas.splitlines():
        named = re.search(r"(?:entry function|Function properties for) '?([\w$]+)", line)
        func = named.group(1) if named else func
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", file=sys.stderr)
            if ("trip_update" in func or "level_pack" in func) and not named:
                log(f"phase 2 ptxas {func}: {line.strip()}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        require(spill is None or spill.groups() == ("0", "0"),
                f"ptxas reports a spill in {func}: {line}")

    def cuda_ms(fn, n: int) -> float:
        """Mean ms of n back-to-back calls between CUDA events, after a warm-up."""
        return benchmarks.cuda_event_ms(fn, repeats=n, nsamples=1)[0]

    def dev_ms(fn, n: int, what: str, cold: bool = False) -> float:
        """Mean device-only kernel ms of n calls (torch.profiler), after a
        warm-up; with cold, the L2 is flushed before each call."""
        ms, per_kernel = device_ms(fn, n, cold_l2=cold)
        log(f"  device ms {what}{' cold L2' if cold else ''}: {ms:.4f} = "
            + " + ".join(f"{name[:48]} {v:.4f}" for name, v in per_kernel.items()))
        return ms

    rng = np.random.default_rng(0)

    def rand_images(b, h, w, c=C):
        return torch.tensor(rng.uniform(0, 255, (b, h, w, c)), dtype=torch.float32,
                            device=dev)

    def motion(ttype, b, h, w):
        """Per-pair motion drawn as eval/benchmarks.py::make_bench_batch."""
        l = max(h, w)
        tr, lin = 3.0, 2.0 / l
        p = np.zeros((b, 8), np.float32)
        p[:, :2] = rng.uniform(-tr, tr, (b, 2))
        if ttype is T.HOMOGRAPHY:
            p[:, [0, 1, 3, 4]] = rng.uniform(-lin, lin, (b, 4))
            p[:, 2] = rng.uniform(-tr, tr, b)
            p[:, 5] = rng.uniform(-tr, tr, b)
            p[:, 6:8] = rng.uniform(-2.0 / (l * l), 2.0 / (l * l), (b, 2))
        elif ttype is T.EUCLIDEAN:
            p[:, 2] = rng.uniform(-lin, lin, b)
        elif ttype is T.AFFINITY:
            p[:, 2:6] = rng.uniform(-lin, lin, (b, 4))
        return torch.tensor(p, device=dev)

    kernels = {}

    def nbytes(*tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(entry, nbyte, nflop):
        """Fill bound_ms/bound_by from the bytes the kernel must move (each
        input read once, each output written once) and its flops, against
        the card's HBM and FP32 peaks."""
        us, by = benchmarks.roofline_bound_us(nbyte, nflop)
        require(us is not None, f"no peak rates known for {card}")
        entry.update(bound_ms=us / 1e3, bound_by=by)

    # ---- phase 3: K3 warp ----
    def check_warp(img_p, gx, gy, what, phase=3):
        got = k3.warp_planar(img_p, gx, gy)
        ref = k3.warp_planar_ref(img_p, gx, gy)
        again = k3.warp_planar(img_p, gx, gy)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"K3 {what}: reruns differ")
        require(torch.equal(torch.isnan(got), torch.isnan(ref)), f"K3 {what}: NaN positions differ")
        fin = ~torch.isnan(ref)
        err = float((got[fin] - ref[fin]).abs().max())
        require(err <= WARP_TOL, f"K3 {what}: max abs err {err} > {WARP_TOL}")
        log(f"phase {phase} K3 {what}: max abs err {err:.3g}, "
            f"NaN {float(torch.isnan(ref).float().mean()):.4f}")
        return err

    img = rand_images(B, H, W)
    img_p = img.permute(0, 3, 1, 2).contiguous()
    gx, gy = ica.transform_grid(motion(T.HOMOGRAPHY, B, H, W), T.HOMOGRAPHY, H, W)
    err3 = check_warp(img_p, gx, gy, f"flagship {B}x{C}x{H}x{W}")
    rot = rand_images(1, 64, 200).permute(0, 3, 1, 2).contiguous()
    p = ica.pad_params(torch.tensor([[0.0, 0.0, 1.2]], device=dev))
    check_warp(rot, *ica.transform_grid(p, T.EUCLIDEAN, 64, 200), "69-degree rotation")
    p = torch.tensor([[-1.2, -2.5, 33.0, 0.04, -3.3, 26.0, 1.5e-3, -0.1]], device=dev)
    check_warp(rot, *ica.transform_grid(p, T.HOMOGRAPHY, 64, 200), "diverged homography")
    kernels["warp_planar"] = dict(
        route="cuda", source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/warp_planar.cu",
        replaces="inverse_compositional_algorithm_tpu/ops/pallas/warp.py:194",
        max_abs_err=err3,
        ms=cuda_ms(lambda: k3.warp_planar(img_p, gx, gy), 50),
        device_ms=dev_ms(lambda: k3.warp_planar(img_p, gx, gy), 50, "K3"),
        cold_device_ms=dev_ms(lambda: k3.warp_planar(img_p, gx, gy), 50, "K3", cold=True),
        plain_ms=cuda_ms(lambda: k3.warp_planar_ref(img_p, gx, gy), 10),
        # F.grid_sample's bicubic uses a = -0.75 and another border rule:
        # no PyTorch call computes this function.
        library_ms=None)
    bound(kernels["warp_planar"], nbytes(img_p, gx, gy) + nbytes(img_p),   # out: img_p's size
          B * H * W * benchmarks.warp_flops_per_pixel(C))

    # ---- phase 4: K4 moments ----
    def check_moments(got, ref, what):
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max())
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite moments")
        require(err / scale <= KERNEL_TOL, f"{what}: normalized err {err / scale} > {KERNEL_TOL}")
        require(bool((got[:, :, 5:, :] == 0).all() and (got[:, :, :, 5:] == 0).all()),
                f"{what}: padding of the [8, 8] moments is not zero")
        log(f"phase {what}: max abs err {err:.3g}, normalized {err / scale:.3g}")
        return err

    maps = torch.tensor(rng.normal(size=(B, 3, H, W)), dtype=torch.float32, device=dev)
    maps = maps * maps
    err4 = check_moments(k4.weighted_moments(maps), k4.weighted_moments_ref(maps),
                         f"4 K4 [{B},3,{H},{W}]")
    kernels["weighted_moments"] = dict(
        route="cuda", source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/weighted_moments.cu",
        replaces="inverse_compositional_algorithm_tpu/ops/pallas/normal_eq.py:117",
        max_abs_err=err4,
        ms=cuda_ms(lambda: k4.weighted_moments(maps), 50),
        device_ms=dev_ms(lambda: k4.weighted_moments(maps), 50, "K4"),
        cold_device_ms=dev_ms(lambda: k4.weighted_moments(maps), 50, "K4", cold=True),
        plain_ms=cuda_ms(lambda: k4.weighted_moments_ref(maps), 10))
    # The library call: the one einsum of moments_ref, powers made beforehand.
    xp = k4._powers(W, 1.0 / max(H, W), 0, maps)
    yp = k4._powers(H, 1.0 / max(H, W), 0, maps)
    kernels["weighted_moments"]["library_ms"] = cuda_ms(
        lambda: torch.einsum("bkyx,xi,yj->bkji", maps, xp, yp), 50)
    bound(kernels["weighted_moments"], nbytes(maps) + B * 3 * 64 * 4,      # out: [B, 3, 8, 8]
          B * H * W * benchmarks.moments_flops_per_pixel(3))

    # ---- phase 5: K1 fused iteration ----
    def k1_inputs(b, h, w, ttype, p, c=C, gen=None):
        """Plan of blurred random c-channel images, and the motion matrices
        of `p` (one motion for every pair) or, when None, of motion(). With
        `gen`, a torch generator on the card, the images are drawn there."""
        def images():
            if gen is None:
                return rand_images(b, h, w, c)
            return torch.rand((b, h, w, c), generator=gen, device=dev) * 255.0

        delta = min(10, (min(h, w) - 1) // 4)
        i1 = pyramid.gaussian_blur(images(), 2.0)
        i2 = pyramid.gaussian_blur(images(), 2.0)
        ix, iy = gradients.central_gradients(i1)
        band = gradients.boundary_band_mask(h, w, delta, device=dev)[None, :, :, None]
        ix, iy = ix * band, iy * band
        plan = k1.plan_fused_iter(i1, i2, ix, iy, *grad_moments(ix, iy), robust=True)
        p = (motion(ttype, b, h, w) if p is None
             else ica.pad_params(torch.tensor([p], device=dev)).expand(b, 8))
        return plan, ica.params_to_matrix(p, ttype).contiguous(), delta

    def check_k1(args, what, phase=5, ref=None):
        """K1 against its plain version (`ref`, when given, is its value):
        reruns bitwise equal, NaN positions equal, the finite moments within
        KERNEL_TOL normalized."""
        got = k1.fused_iter_moments(*args)
        ref = k1.fused_iter_moments_ref(*args) if ref is None else ref
        again = k1.fused_iter_moments(*args)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"K1 {what}: reruns differ")
        fin = torch.isfinite(ref)
        require(torch.equal(torch.isfinite(got), fin), f"K1 {what}: non-finite positions differ")
        scale = max(1.0, float(ref[fin].abs().max()))
        err = float((got[fin] - ref[fin]).abs().max())
        require(err / scale <= KERNEL_TOL, f"K1 {what}: normalized err {err / scale} > {KERNEL_TOL}")
        require(bool((got[:, :, 5:, :] == 0).all() and (got[:, :, :, 5:] == 0).all()),
                f"K1 {what}: padding of the [8, 8] moments is not zero")
        log(f"phase {phase} K1 {what}: max abs err {err:.3g}, normalized {err / scale:.3g}, "
            f"non-finite {float((~fin).float().mean()):.3f}")
        return err

    all3 = [(R.CHARBONNIER, True), (None, True), (R.CHARBONNIER, False)]
    k1_cases = [     # what, batch, h, w, motion model, motion (None: drawn), losses
        ("flagship", B, H, W, T.HOMOGRAPHY, None, all3),
        ("coarse", B, *COARSE, T.HOMOGRAPHY, None, all3),
        ("ragged 49x73", 2, 49, 73, T.EUCLIDEAN, [1.5, -0.5, 0.05], all3[:1]),
        ("batch 1", 1, H, W, T.HOMOGRAPHY, None, all3[:1]),
        ("batch 16", 16, H, W, T.HOMOGRAPHY, None, all3[:1]),
        ("69-degree rotation", 2, 64, 200, T.EUCLIDEAN, [0.0, 0.0, 1.2], all3[:2]),
        ("diverged homography", 2, 64, 200, T.HOMOGRAPHY,
         [-1.2, -2.5, 33.0, 0.04, -3.3, 26.0, 1.5e-3, -0.1], all3[:2]),
    ]
    for what, b, h, w, ttype, p, losses in k1_cases:
        plan, mat, delta = k1_inputs(b, h, w, ttype, p)
        lam = torch.linspace(5.0, 80.0, b, device=dev)
        for robust, nan in losses:
            args = (plan.i2p, plan.tplp, mat, ttype is T.HOMOGRAPHY, lam, h, w, robust, nan, delta)
            err = check_k1(args, f"{what} {b}x{h}x{w} {robust.name if robust else 'QUADRATIC'} "
                                 f"nanifoutside={nan}")
            if what == "flagship" and robust is not None and nan:
                kernels["fused_iter_moments"] = dict(
                    route="cuda",
                    source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/fused_iter.cu",
                    replaces="inverse_compositional_algorithm_tpu/ops/pallas/fused_iter.py:312",
                    max_abs_err=err,
                    ms=cuda_ms(lambda: k1.fused_iter_moments(*args), 50),
                    device_ms=dev_ms(lambda: k1.fused_iter_moments(*args), 50, "K1"),
                    cold_device_ms=dev_ms(lambda: k1.fused_iter_moments(*args), 50, "K1",
                                          cold=True),
                    plain_ms=cuda_ms(lambda: k1.fused_iter_moments_ref(*args), 10),
                    library_ms=None)          # no PyTorch call fuses this chain
                bound(kernels["fused_iter_moments"],
                      nbytes(plan.i2p, plan.tplp, mat, lam) + B * 5 * 64 * 4,  # out: [B, 5, 8, 8]
                      B * h * w * benchmarks.fused_iter_flops_per_pixel(C))

    # K1's other instances: <1> for gray, <0> for any C but 1 and 3 (a
    # four-band tile's); robust and quadratic, both nanifoutside forms.
    affine = [1.0, -1.0, 0.05, -0.02, 0.08, -0.04]
    both4 = [(R.LORENTZIAN, True), (R.LORENTZIAN, False), (None, True), (None, False)]
    for c, b, h, w, losses in [(1, 2, 49, 73, both4), (2, 2, 49, 73, both4),
                               (4, 2, 49, 73, both4), (4, 1, 1080, 1920, both4[:1])]:
        plan, mat, delta = k1_inputs(b, h, w, T.AFFINITY, affine, c=c)
        lam = torch.linspace(5.0, 80.0, b, device=dev)
        for robust, nan in losses:
            args = (plan.i2p, plan.tplp, mat, False, lam, h, w, robust, nan, delta)
            check_k1(args, f"{c}-channel {b}x{h}x{w} AFFINITY "
                           f"{robust.name if robust else 'QUADRATIC'} nanifoutside={nan}")

    # K1's <0> instance and K3 on one whole Sentinel-2 tile pair (10980 x
    # 10980, four bands, the sentinel2_affine_lorentzian configuration's
    # LORENTZIAN with nanifoutside): its 15 packed planes reach 84% of K1's
    # 32-bit offsets. The plain K1 is summed over bands of rows (its
    # y_offset), as phase 12's row shards are, so that it fits the card.
    th = tw = 10980
    tile_p = [2.3, -1.7, 1.6 / tw, -0.9 / tw, 1.2 / tw, -1.8 / tw]
    plan, mat, delta = k1_inputs(1, th, tw, T.AFFINITY, tile_p, c=4,
                                 gen=torch.Generator(device=dev).manual_seed(14))
    args = (plan.i2p, plan.tplp, mat, False, torch.tensor([5.0], device=dev), th, tw,
            R.LORENTZIAN, True, delta)
    rows = -(-th // 8)
    ref = sum(k1.fused_iter_moments_ref(*args[:1], plan.tplp[:, :, r:r + rows], *args[2:],
                                        y_offset=r) for r in range(0, th, rows))
    check_k1(args, f"tile 1x4x{th}x{tw} AFFINITY LORENTZIAN nanifoutside=True", ref=ref)
    check_warp(plan.i2p, *ica.transform_grid(ica.pad_params(torch.tensor([tile_p], device=dev)),
                                             T.AFFINITY, th, tw),
               f"tile 1x4x{th}x{tw} AFFINITY", phase=5)
    del plan, mat, args, ref
    torch.cuda.empty_cache()

    # ---- phase 5c: K7 level set-up ----
    # K7 against the set-up's op chain (pack_level_ref): the packed images
    # and gradients bitwise, each gradient moment within 2(C - 1) units of
    # 2^-24 of its products' magnitude sum (ATen sums the channels in its
    # own order), reruns bitwise; robust at the finest level of
    # homography_charbonnier.bulk_b1024_584x388 (timed) and on one whole
    # four-band Sentinel-2 tile pair (15 planes, 84% of the 32-bit offsets),
    # quadratic (the moments in their own planes, for K4) at the finest level
    # of euclidean_quadratic.clip_b64_1080p.
    def bitwise(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def check_pack(i1, i2, delta, robust, what):
        c = i1.shape[-1]
        got = k7.pack_level(i1, i2, delta, True, robust)
        again = k7.pack_level(i1, i2, delta, True, robust)
        torch.cuda.synchronize()
        require(bitwise(got.tplp, again.tplp) and bitwise(got.i2p, again.i2p)
                and (robust or bitwise(got.gmom, again.gmom)), f"K7 {what}: reruns differ")
        del again
        ref = k7.pack_level_ref(i1, i2, delta, True, robust)
        torch.cuda.synchronize()
        require(bitwise(got.i2p, ref.i2p) and bitwise(got.tplp[:, :3 * c], ref.tplp[:, :3 * c]),
                f"K7 {what}: the packed images or gradients differ from the chain's")
        require((got.gmom is None) == robust and (robust or got.gmom.shape == ref.gmom.shape),
                f"K7 {what}: the moments are not where the loss wants them")
        units, err = k7.moment_gap(got, ref)
        require(units <= 2 * (c - 1), f"K7 {what}: a gradient moment beyond its bound")
        log(f"phase 5c K7 {what}: images and gradients bitwise the chain's, moments within "
            f"{units:.3g} units of 2^-24 of their magnitude sum (max abs err {err:.3g})")
        return err

    gen = torch.Generator(device=dev).manual_seed(15)
    kb7 = 1024
    pi1, pi2 = (torch.rand((kb7, H, W, C), generator=gen, device=dev) * 255.0 for _ in range(2))
    err7 = check_pack(pi1, pi2, 10, True, f"bulk finest {kb7}x{H}x{W}x{C} robust")
    torch.cuda.empty_cache()
    packed = k7.pack_level(pi1, pi2, 10, True, True)

    def pack():          # drops its plan: the timers keep what a call returns
        k7.pack_level(pi1, pi2, 10, True, True)

    kernels["level_pack"] = dict(
        route="cuda",
        source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/level_pack.cu",
        replaces="none: a level's set-up chain (central_gradients, band, grad_moments, "
                 "plan_fused_iter; ~20 ATen passes), which XLA fuses in the JAX package",
        max_abs_err=err7,
        ms=cuda_ms(pack, 20),
        device_ms=dev_ms(pack, 20, "K7"),
        cold_device_ms=dev_ms(pack, 20, "K7", cold=True),
        plain_ms=cuda_ms(lambda: k7.pack_level_ref(pi1, pi2, 10, True, True), 5),
        library_ms=None)          # no PyTorch call computes this chain
    # Reads i1 and i2 once, writes the 3C + 3 packed planes and i2's C planes
    # once; about 12 flops a pixel and channel.
    bound(kernels["level_pack"], nbytes(pi1, pi2, packed.tplp, packed.i2p),
          kb7 * H * W * C * 12)
    log(f"phase 5c K7 bulk finest: {kernels['level_pack']['device_ms']:.3f} ms device, bound "
        f"{kernels['level_pack']['bound_ms']:.3f} ms, chain {kernels['level_pack']['plain_ms']:.3f}"
        f" ms ({card})")
    del pi1, pi2, packed
    torch.cuda.empty_cache()
    ti1, ti2 = (torch.rand((1, th, tw, 4), generator=gen, device=dev) * 255.0 for _ in range(2))
    check_pack(ti1, ti2, 10, True, f"tile 1x{th}x{tw}x4 robust")
    log(f"phase 5c K7 tile: {cuda_ms(lambda: k7.pack_level(ti1, ti2, 10, True, True), 5):.3f} ms, "
        f"chain {cuda_ms(lambda: k7.pack_level_ref(ti1, ti2, 10, True, True), 2):.3f} ms")
    del ti1, ti2
    torch.cuda.empty_cache()
    qi1, qi2 = (torch.rand((64, 1080, 1920, C), generator=gen, device=dev) * 255.0
                for _ in range(2))
    check_pack(qi1, qi2, 10, False, f"clip finest 64x1080x1920x{C} quadratic")
    del qi1, qi2
    torch.cuda.empty_cache()

    def corner_err(pa, pb, ttype, h=H, w=W):
        xs, ys = ([0.0, w - 1.0, 0.0, w - 1.0], [0.0, 0.0, h - 1.0, h - 1.0])
        ax, ay = transform_points(pa.double(), ttype, xs, ys)
        bx, by = transform_points(pb.double(), ttype, xs, ys)
        return float(torch.hypot(ax - bx, ay - by).max())

    # ---- phase 5b: K6 trip update ----
    # One trip of a solve near its answer, on the flagship's 97x146 level:
    # K1's moments of synthetic pairs, a state 0.05 px off the ground truth
    # with a fifth of the pairs already done (at batch 1 the pair goes on).
    # The robust homography (batch 1024) and the four-band affine Lorentzian
    # (batch 1, a Sentinel-2 tile's trip) anneal lambda and assemble H from
    # the moments; the quadratic Euclidean (batch 1024) takes K4's hoisted
    # Hessian. p and the motion matrices are held by their corners'
    # displacement, which weighs each parameter by how far it moves the
    # frame.
    kh, kw = 97, 146
    kbases = {C: pyramid.gaussian_blur(rand_images(1, kh, kw), 2.0)}
    kdelta = min(10, (min(kh, kw) - 1) // 4)
    band = gradients.boundary_band_mask(kh, kw, kdelta, device=dev)[None, :, :, None]
    # Each live parameter's change that moves a corner by about 1 px.
    k6_px = {T.HOMOGRAPHY: [1.0 / kw, 1.0 / kw, 1.0, 1.0 / kw, 1.0 / kw, 1.0,
                            1.0 / kw ** 2, 1.0 / kw ** 2],
             T.EUCLIDEAN: [1.0, 1.0, 1.0 / kw],
             T.AFFINITY: [1.0, 1.0, 1.0 / kw, 1.0 / kw, 1.0 / kw, 1.0 / kw]}

    def mat_corner_err(ma, mb):
        """Max px between the frame's corners mapped by [B, 3, 3] matrices."""
        xy = torch.tensor([[0.0, 0.0, 1.0], [kw - 1.0, 0.0, 1.0], [0.0, kh - 1.0, 1.0],
                           [kw - 1.0, kh - 1.0, 1.0]], dtype=torch.float64, device=dev)
        qa, qb = xy @ ma.double().transpose(1, 2), xy @ mb.double().transpose(1, 2)
        return float((qa[..., :2] / qa[..., 2:] - qb[..., :2] / qb[..., 2:]).norm(dim=-1).max())

    for ttype, robust, kb, kc in ((T.HOMOGRAPHY, R.CHARBONNIER, 1024, C),
                                  (T.EUCLIDEAN, None, 1024, C),
                                  (T.AFFINITY, R.LORENTZIAN, 1, 4)):
        what = f"{ttype.name} {robust.name if robust else 'QUADRATIC'}"
        if kc not in kbases:
            kbases[kc] = pyramid.gaussian_blur(rand_images(1, kh, kw, kc), 2.0)
        kbase = kbases[kc].expand(kb, kh, kw, kc)
        p_gt = motion(ttype, kb, kh, kw)
        ki1 = warp.bicubic_sample(kbase, *ica.transform_grid(p_gt, ttype, kh, kw))
        kix, kiy = gradients.central_gradients(ki1)
        kix, kiy = kix * band, kiy * band
        kg = grad_moments(kix, kiy)
        kplan = k1.plan_fused_iter(ki1, kbase.contiguous(), kix, kiy, *kg,
                                   robust=robust is not None)
        step = ica.pad_params(torch.tensor(k6_px[ttype], device=dev))
        kp = p_gt + torch.tensor(rng.uniform(-0.05, 0.05, (kb, 8)), dtype=torch.float32,
                                 device=dev) * step
        klam = torch.tensor(rng.choice([80.0, 42.5, 5.5, 5.0], kb), dtype=torch.float32,
                            device=dev)
        km = k1.fused_iter_moments(kplan.i2p, kplan.tplp, ica.params_to_matrix(kp, ttype),
                                   ttype is T.HOMOGRAPHY, klam, kh, kw, robust, True, kdelta)
        h_quad = None if robust else k4.fused_hessian(*kg, ttype=ttype)
        kstate = ica.ICState(
            p=kp, error=torch.full((kb,), 1e10, device=dev), lam=klam, it=3,
            niters=torch.full((kb,), 3, dtype=torch.int32, device=dev),
            active=torch.tensor((rng.uniform(size=kb) > 0.2) | (kb == 1), device=dev),
            diverged=torch.zeros(kb, dtype=torch.bool, device=dev))
        ktrip = k6.plan_kernel_trip(
            k6.plan_trip(p_gt.clone(), ttype, kh, kw, tol=1e-3, max_iter=30,
                         anneal=robust is not None, scale=param_preconditioner(ttype, kh, kw),
                         divergence_guard=True), h_quad)

        def k6_state():
            return ica.ICState(p=kstate.p.clone(), error=kstate.error.clone(),
                               lam=kstate.lam.clone(), it=kstate.it,
                               niters=kstate.niters.clone(), active=kstate.active.clone(),
                               diverged=kstate.diverged.clone())

        def k6_plain():
            b = k4._assemble_b(km[:, -2:], ttype, kh, kw)
            h = h_quad if h_quad is not None else k4._assemble_h(km[:, :3], ttype, kh, kw)
            return k6.trip_update_ref(h, b, kstate, ktrip)

        want = k6_plain()
        got, again = k6_state(), k6_state()
        k6.trip_update(km, got, ktrip)
        going = ktrip.count.tolist()
        ktrip.count.zero_()
        k6.trip_update(km, again, ktrip)
        torch.cuda.synchronize()
        k6_err = {}
        for name, w in zip(("p", "error", "lam", "niters", "active", "diverged"), want):
            g = getattr(got, name)
            require(torch.equal(g, getattr(again, name)), f"K6 {what} {name}: reruns differ")
            if g.is_floating_point():
                k6_err[name] = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            else:
                require(torch.equal(g, w), f"K6 {what} {name} differs from the plain version")
        want_mat = ica.params_to_matrix(want[0], ttype)
        k6_err["mat"] = float((ktrip.mat - want_mat).abs().max())
        require(going == [0, int(want[4].sum())] and going == ktrip.count.tolist(),
                f"K6 {what} count {going} against {int(want[4].sum())} pairs going on")
        require(max(k6_err.values()) <= TRIP_TOL,
                f"K6 {what}: normalized err {k6_err} > {TRIP_TOL}")
        moved = corner_err(want[0], kstate.p, ttype, kh, kw)
        corner = {"p": corner_err(got.p, want[0], ttype, kh, kw),
                  "mat": mat_corner_err(ktrip.mat, want_mat)}
        require(max(corner.values()) <= TRIP_CORNER_TOL,
                f"K6 {what}: corner err {corner} px > {TRIP_CORNER_TOL}")
        log(f"phase 5b K6 {kb}x{kc}x{kh}x{kw} {what}: normalized err {k6_err}, corner err "
            f"p {corner['p']:.3g} px, mat {corner['mat']:.3g} px (the step moved corners "
            f"{moved:.3g} px), going on {int(want[4].sum())} of {kb}")
        if ttype is not T.HOMOGRAPHY:
            continue
        kernels["trip_update"] = dict(
            route="cuda",
            source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/trip_update.cu",
            replaces="none: the solver trip's update after K1 (models/ic.py::iterate, ~480 "
                     "ATen launches a trip before it)",
            max_abs_err=max(k6_err.values()),
            ms=cuda_ms(lambda: k6.trip_update(km, got, ktrip), 50),
            device_ms=dev_ms(lambda: k6.trip_update(km, got, ktrip), 50, "K6"),
            cold_device_ms=dev_ms(lambda: k6.trip_update(km, got, ktrip), 50, "K6",
                                  cold=True),
            plain_ms=cuda_ms(k6_plain, 10),
            library_ms=None)          # no PyTorch call computes this chain
        # Reads: the 5x5 corner of each 8x8 moment block (five 32-byte rows),
        # the contraction tensors, the state; writes: the state and the
        # matrices. p0 is read only by a reverted pair.
        bound(kernels["trip_update"],
              kb * km.shape[1] * 5 * 8 * 4 + nbytes(ktrip.t_h, ktrip.t_b)
              + 2 * nbytes(*want) + nbytes(ktrip.mat),
              kb * TRIP_FLOPS)

    # ---- phase 6: the main path end to end ----
    base = pyramid.gaussian_blur(rand_images(1, H, W), 2.0)[0]

    def pairs(ttype):
        p_gt = motion(ttype, B, H, W)
        gx, gy = ica.transform_grid(p_gt, ttype, H, W)
        i1 = warp.bicubic_sample(base.expand(B, H, W, C), gx, gy)
        return i1, base.expand(B, H, W, C).contiguous(), p_gt

    # Each kernel's launch count: the wrapper's module and its counter.
    counters = {"fused_iter_moments": (k1, "LAUNCHES"), "warp_planar": (k3, "LAUNCHES"),
                "weighted_moments": (k4, "LAUNCHES"), "warp_floor": (k5, "LAUNCHES"),
                "fused_iter_ablate": (k1, "ABLATE_LAUNCHES"), "trip_update": (k6, "LAUNCHES"),
                "level_pack": (k7, "LAUNCHES")}
    launches = {k: 0 for k in counters}

    def window(fn):
        """Run an entry point with every launch count set to 0 just before
        and read just after; the counts add into `launches`."""
        for m, attr in counters.values():
            setattr(m, attr, 0)
        out = fn()
        torch.cuda.synchronize()
        counts = {k: getattr(m, attr) for k, (m, attr) in counters.items()}
        for k, v in counts.items():
            launches[k] += v
        return out, counts

    flagship = ica.AlignConfig(transform=T.HOMOGRAPHY, robust=R.CHARBONNIER, lam=0.0,
                               nscales=5, nu=0.5, delta=10)
    default = ica.AlignConfig()
    runs, motion_of = {}, {}
    for name, cfg in [("flagship", flagship), ("default", default)]:
        i1, i2, p_gt = pairs(cfg.transform)
        motion_of[name] = p_gt
        res, counts = window(lambda: ica.align(i1, i2, cfg))
        require(res.p.shape == (B, 8) and res.iw.shape == (B, H, W, C), f"{name}: shapes")
        require(bool(torch.isfinite(res.p).all()), f"{name}: non-finite p")
        require(not bool(res.diverged.any()), f"{name}: a pair diverged")
        err = corner_err(res.p, p_gt, cfg.transform)
        require(err <= CORNER_TOL_GT, f"{name}: corner err vs ground truth {err} px")
        log(f"phase 6 align {name}: corner err vs ground truth {err:.3g} px, niters "
            f"{res.niters.tolist()}, launches {counts}")
        runs[name] = dict(cfg=cfg, i1=i1, i2=i2, res=res, counts=counts)
    fl, de = runs["flagship"]["counts"], runs["default"]["counts"]
    require(fl["fused_iter_moments"] > 0 and fl["warp_planar"] > 0,
            f"flagship align did not launch K1 and K3: {fl}")
    require(de["weighted_moments"] > 0 and de["fused_iter_moments"] > 0,
            f"default align did not launch K4 and K1: {de}")
    for name, c in (("flagship", fl), ("default", de)):
        require(c["trip_update"] == c["fused_iter_moments"],
                f"{name} align: a trip did not take K6: {c}")
        require(c["level_pack"] == runs[name]["cfg"].nscales,
                f"{name} align: K7 did not pack each level once: {c}")

    for name, run in runs.items():
        cpu = ica.align(run["i1"][:2].cpu(), run["i2"][:2].cpu(), run["cfg"])
        err = corner_err(run["res"].p[:2].cpu(), cpu.p, run["cfg"].transform)
        require(err <= CORNER_TOL_CPU, f"{name}: CUDA vs CPU corner err {err} px")
        log(f"phase 6 {name} CUDA vs CPU plain align (2 pairs): corner err {err:.3g} px, "
            f"niters {run['res'].niters[:2].tolist()} vs {cpu.niters.tolist()}")

    # ---- phase 7: time per align call (informational) ----
    for name, run in runs.items():
        ms = cuda_ms(lambda: ica.align(run["i1"], run["i2"], run["cfg"]), 5)
        log(f"phase 7 align {name} batch {B}: {ms:.2f} ms per call ({card})")

    # ---- phase 8: K5 warp floor ----
    def check_floor(x, tma, what):
        """K5 on x against its plain version: the load path the wrapper
        picks, the shape, reruns bitwise equal, within WARP_TOL."""
        b, c, h, w = x.shape
        what = f"{what} {b}x{c}x{h}x{w}"
        require(k5.uses_tma(x) == tma, f"K5 {what}: uses_tma is not {tma}")
        before = k5.LAUNCHES
        got, again = k5.warp_floor(x), k5.warp_floor(x)
        ref = k5.warp_floor_ref(x)
        torch.cuda.synchronize()
        require(k5.LAUNCHES == before + 2, f"K5 {what}: the kernel was not launched")
        require(got.shape == (b, c, h - 3, w - 3), f"K5 {what}: shape {tuple(got.shape)}")
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"K5 {what}: reruns differ")
        err = float((got - ref).abs().max())
        require(err <= WARP_TOL, f"K5 {what}: max abs err {err} > {WARP_TOL}")
        log(f"phase 8 K5 {what} ({'TMA' if tma else 'plain'} loads): max abs err {err:.3g}")
        return err, got

    def rand_planes(b, c, h, w, offset=0):
        """Random [b, c, h, w] planes whose storage starts `offset` floats
        into its buffer."""
        x = torch.empty(offset + b * c * h * w, dtype=torch.float32, device=dev)[offset:]
        x.copy_(torch.tensor(rng.uniform(0, 255, x.numel()), dtype=torch.float32))
        return x.view(b, c, h, w)

    err5, got = check_floor(img_p, True, "flagship")
    for shape, tma, what, offset in [((1, 3, 45, 135), False, "ragged", 0),
                                     ((1, 3, 45, 136), False, "misaligned base", 1),
                                     ((2, 1, 97, 148), True, "gray", 0),
                                     ((1, 3, 4, 4), True, "minimum", 0),
                                     ((1, 3, 2160, 3840), True, "4K", 0)]:
        check_floor(rand_planes(*shape, offset=offset), tma, what)
    kernels["warp_floor"] = dict(
        route="cuda", source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/warp_floor.cu",
        replaces="inverse_compositional_algorithm_tpu/eval/benchmarks.py:331",
        max_abs_err=err5,
        ms=cuda_ms(lambda: k5.warp_floor(img_p), 50),
        device_ms=dev_ms(lambda: k5.warp_floor(img_p), 50, "K5"),
        cold_device_ms=dev_ms(lambda: k5.warp_floor(img_p), 50, "K5", cold=True),
        plain_ms=cuda_ms(lambda: k5.warp_floor_ref(img_p), 10),
        library_ms=None)   # per-pixel weights: no convolution or PyTorch call computes it
    bound(kernels["warp_floor"], nbytes(img_p, got),
          B * (H - 3) * (W - 3) * benchmarks.warp_flops_per_pixel(C))

    # ---- phase 9: the benchmark entry point, full record ----
    t0 = time.perf_counter()
    rec, counts = window(benchmarks.run_benchmark)
    log(f"phase 9 run_benchmark: {time.perf_counter() - t0:.1f} s, launches {counts}")
    print("bench_record " + json.dumps(rec), flush=True)
    samples = [rec["samples"], rec["hard_motion"]["samples"], rec["fixed_30_iters"]["samples"],
               rec["roofline"]["fused_iter_samples"], rec["warp_roofline"]["warp_samples"],
               rec["vpu_floor"]["floor_samples"],
               *(line["samples"] for line in rec["large_frame"].values())]
    for smp in samples:
        require(all(v > 0 for k, v in smp.items() if k != "n"), f"bench: a sample <= 0: {smp}")
    require(len(rec["large_frame"]) == 3, "bench: large-frame lines missing")
    require(rec["card"]["name"] == torch.cuda.get_device_name(0)
            and rec["card"]["nvidia_smi"] == card, f"bench: record names {rec['card']}")
    require(all(counts[k] > 0 for k in ("fused_iter_moments", "warp_planar", "warp_floor")),
            f"run_benchmark did not launch K1, K3 and K5: {counts}")
    rf, wr = rec["roofline"], rec["warp_roofline"]
    fl = rec["vpu_floor"]
    log(f"phase 9 bench: {rec['value']:.3f} pairs/s (batch {B}), fused/floor "
        f"{fl['fused_over_floor']:.3f} (event), {fl['fused_over_floor_device']:.3f} (device); "
        f"K1 {rf['fused_iter_gbs']:.0f} GB/s (event), {rf['fused_iter_device_gbs']:.0f} GB/s "
        f"(device); K3 {wr['warp_gbs']:.0f} / {wr['warp_device_gbs']:.0f} GB/s; K5 "
        f"{fl['floor_gbs']:.0f} / {fl['floor_device_gbs']:.0f} / "
        f"{fl['floor_cold_device_gbs']:.0f} GB/s (cold L2)")

    # ---- phase 10: the stage profile ----
    table, counts = window(profile_stages.profile_stages)
    require(all(v > 0 for k, v in table.items() if k not in ("pct_hbm_peak", "device_ms")),
            f"profile: a stage time <= 0: {table}")
    require(all(v > 0 for v in table["device_ms"].values()),
            f"profile: a stage device time <= 0: {table['device_ms']}")
    log(f"phase 10 profile_stages: {len(table)} rows, launches {counts}")
    print("profile_stages " + json.dumps(table), flush=True)

    # ---- phase 11: the accuracy sweeps ----
    images = np.stack(run_eval._procedural_textures(EVAL_N, EVAL_SIZE, seed=0))
    base_cfg = ica.AlignConfig(transform=T.EUCLIDEAN, robust=R.CHARBONNIER, nscales=3)
    (clean, occl), counts = window(lambda: (harness.evaluate_transforms(images, base_cfg),
                                            harness.evaluate_occlusion(images, base_cfg)))
    for r in clean:
        log(f"phase 11 eval {r.transform}: mae {r.mae:.3g}, max {r.max_err:.3g}, "
            f"converged {r.converged_frac}, {r.pairs_per_sec:.1f} pairs/s")
        require(r.mae <= EVAL_MAE and r.converged_frac == 1.0,
                f"eval {r.transform}: mae {r.mae}, converged {r.converged_frac}")
    for r in occl:
        log(f"phase 11 occlusion {r.robust}: mae {r.mae:.3g}, max {r.max_err:.3g}, "
            f"converged {r.converged_frac}")
        if r.robust == "QUADRATIC":
            require(r.mae > OCCL_MAE_QUADRATIC, f"occlusion QUADRATIC did not degrade: {r.mae}")
        else:
            require(r.mae <= OCCL_MAE_ROBUST, f"occlusion {r.robust}: mae {r.mae}")
    require(all(counts[k] > 0 for k in ("fused_iter_moments", "warp_planar", "weighted_moments")),
            f"the eval sweeps did not launch K1, K3 and K4: {counts}")
    log(f"phase 11 eval launches {counts}")

    # ---- phase 12: the scale-out layer ----
    # (a) K1 and K3 as the row-tiled path runs them, on the flagship batch
    # and on one 3840x2160 pair, in 2 and 4 row shards: K1 on each shard
    # (Ho = H/nt, y_offset = the shard's first row) against its plain
    # version, and the shards' sum against the whole frame's; K3 on each
    # shard's output rows, sampling the whole source, against its plain
    # version and, bit for bit, against the whole-frame warp's rows.
    def check_shards(b, h, w):
        plan, mat, delta = k1_inputs(b, h, w, T.HOMOGRAPHY, None)
        lam = torch.linspace(5.0, 80.0, b, device=dev)
        whole = k1.fused_iter_moments(plan.i2p, plan.tplp, mat, True, lam, h, w, R.CHARBONNIER,
                                      True, delta)
        pm = motion(T.HOMOGRAPHY, b, h, w)
        whole3 = k3.warp_planar(plan.i2p, *ica.transform_grid(pm, T.HOMOGRAPHY, h, w))
        for nt in (2, 4):
            rows, total = h // nt, 0
            for r in range(nt):
                y0 = r * rows
                what = f"row shard {r} of {nt} ({rows} rows from row {y0}) of {b}x{C}x{h}x{w}"
                shard = (plan.i2p, plan.tplp[:, :, y0:y0 + rows].contiguous(), mat, True,
                         lam, h, w, R.CHARBONNIER, True, delta, y0)
                check_k1(shard, what, phase=12)
                total = total + k1.fused_iter_moments(*shard)
                gxr, gyr = ica.transform_grid(pm, T.HOMOGRAPHY, rows, w, y_offset=y0)
                check_warp(plan.i2p, gxr, gyr, what, phase=12)
                got = k3.warp_planar(plan.i2p, gxr, gyr)
                require(torch.equal(got.view(torch.int32),
                                    whole3[:, :, y0:y0 + rows].view(torch.int32)),
                        f"K3 {what}: not the whole-frame warp's rows")
            torch.cuda.synchronize()
            scale = max(1.0, float(whole.abs().max()))
            err = float((total - whole).abs().max()) / scale
            require(err <= KERNEL_TOL,
                    f"K1 {nt} row shards of {b}x{h}x{w}: sum vs whole frame {err} > {KERNEL_TOL}")
            log(f"phase 12 K1 sum of {nt} row shards of {b}x{h}x{w} vs whole frame: "
                f"normalized err {err:.3g}; K3 rows equal the whole-frame warp's")

    check_shards(B, H, W)
    check_shards(1, 2160, 3840)

    def sharded(name, world, mesh, i1, i2, backend=None, repeats=3):
        """align_sharded(flagship config) on `world` ranks of a pairs x tile
        `mesh`, each rank's K1 and K3 launched and counted."""
        cases = {name: {"entry": "align_sharded", "mesh": mesh,
                        "kwargs": {"config": flagship, "tile_rows": mesh[1] > 1}}}
        outs = run_ranks(drive, world, device="cuda", backend=backend, timeout_s=RANK_TIMEOUT,
                         args={f"{name}.i1": i1.cpu().numpy(), f"{name}.i2": i2.cpu().numpy()},
                         kwargs={"cases": cases, "repeats": repeats, "keep_images": False})
        for o in outs:
            got = o["launches"]
            require(got["fused_iter_moments"] > 0 and got["warp_planar"] > 0,
                    f"{name}: a rank did not launch K1 and K3: {got}")
            require(o["out"][f"{name}.iw_finite"], f"{name}: non-finite Iw on a rank")
            require(np.array_equal(o["out"][f"{name}.p"], outs[0]["out"][f"{name}.p"]),
                    f"{name}: the ranks disagree on p")
            for k, v in got.items():
                launches[k] += v
        out = outs[0]["out"]
        return (torch.tensor(out[f"{name}.p"]), torch.tensor(out[f"{name}.diverged"]),
                max(o["out"][f"{name}.ms"] for o in outs), [o["launches"] for o in outs])

    def check_sharded(what, got, res, p_gt, h, w, world_note):
        p, diverged, ms, counts = got
        e_gt = corner_err(p, p_gt.cpu(), T.HOMOGRAPHY, h, w)
        e_one = corner_err(p, res.p.cpu(), T.HOMOGRAPHY, h, w)
        require(e_gt <= CORNER_TOL_GT, f"{what}: corner err vs ground truth {e_gt} px")
        require(e_one <= CORNER_TOL_CPU, f"{what}: corner err vs single-card align {e_one} px")
        require(torch.equal(diverged, res.diverged.cpu()), f"{what}: diverged flags differ")
        log(f"phase 12 {what}: corner err vs ground truth {e_gt:.3g} px, vs single-card "
            f"align {e_one:.3g} px, {ms:.2f} ms per call ({world_note}; {card}), launches {counts}")

    # (b) Row-tiled over 2 gloo ranks that share the card: not a scaling
    # number (two processes on one card), the path and its kernels.
    flag, p_gt = runs["flagship"], motion_of["flagship"]
    ms1 = cuda_ms(lambda: ica.align(flag["i1"], flag["i2"], flagship), 3)
    log(f"phase 12 single-card align flagship {B}x{H}x{W}: {ms1:.2f} ms per call ({card})")
    check_sharded(f"align_sharded flagship {B}x{H}x{W} tile 2",
                  sharded("flag", 2, (1, 2), flag["i1"], flag["i2"], backend="gloo"),
                  flag["res"], p_gt, H, W, "2 gloo ranks sharing cuda:0")
    H4, W4 = 2160, 3840
    base4 = pyramid.gaussian_blur(rand_images(1, H4, W4), 2.0)
    p4 = motion(T.HOMOGRAPHY, 1, H4, W4)
    i1_4 = warp.bicubic_sample(base4, *ica.transform_grid(p4, T.HOMOGRAPHY, H4, W4))
    res4, counts = window(lambda: ica.align(i1_4, base4, flagship))
    ms4 = cuda_ms(lambda: ica.align(i1_4, base4, flagship), 3)
    log(f"phase 12 single-card align 1x{H4}x{W4}: corner err vs ground truth "
        f"{corner_err(res4.p, p4, T.HOMOGRAPHY, H4, W4):.3g} px, {ms4:.2f} ms per call "
        f"({card}), launches {counts}")
    check_sharded(f"align_sharded 1x{H4}x{W4} tile 2",
                  sharded("4k", 2, (1, 2), i1_4, base4, backend="gloo"), res4, p4, H4, W4,
                  "2 gloo ranks sharing cuda:0")
    del base4, i1_4

    # (c) NCCL: one rank (align_sharded and the launcher), then one rank per
    # card, pairs x tile, where the machine has 2 cards or more.
    check_sharded(f"align_sharded flagship {B}x{H}x{W} pairs 1",
                  sharded("one", 1, (1, 1), flag["i1"], flag["i2"]), flag["res"], p_gt, H, W,
                  "1 NCCL rank")
    outs = run_ranks(run_launch, 1, device="cuda", timeout_s=RANK_TIMEOUT,
                     kwargs={"argv": ["--batch-per-host", str(B), "--repeats", "3"]})
    rec, got = outs[0]["out"], outs[0]["launches"]
    require(rec["errors_finite"] and rec["pairs_per_sec_global"] > 0 and rec["card"] == card
            and rec["max_corner_err_px"] <= CORNER_TOL_GT, f"launch: {rec}")
    require(got["fused_iter_moments"] > 0 and got["warp_planar"] > 0,
            f"launch did not launch K1 and K3: {got}")
    for k, v in got.items():
        launches[k] += v
    print("launch_record " + json.dumps(rec), flush=True)
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        n = min(4, ncards - ncards % 2)
        check_sharded(f"align_sharded flagship {B}x{H}x{W} pairs {n // 2} x tile 2",
                      sharded("nccl", n, (n // 2, 2), flag["i1"], flag["i2"]), flag["res"], p_gt,
                      H, W, f"{n} NCCL ranks, one per card")

    # ---- phase 13: K1's ablation variants, attr_bench, the walkthrough, the shims ----
    # (a) The variants against the production K1 on 2 flagship pairs at
    # delta 10 (comparison launches, outside every window).
    def bench_args(b):
        i1b, i2b, p0b, _, _, ixb, iyb, g3b = benchmarks.hot_state(b, H, W, T.HOMOGRAPHY)
        plan = k1.plan_fused_iter(i1b, i2b, ixb, iyb, *g3b, robust=True)
        return (plan.i2p, plan.tplp, ica.params_to_matrix(p0b, T.HOMOGRAPHY).contiguous(),
                True, torch.full((b,), 5.0, device=dev), H, W, R.CHARBONNIER, True, 10)

    args = bench_args(2)
    prod = k1.fused_iter_moments(*args)
    for name, hop in attr_bench.HOPPER.items():
        if hop is None:
            log(f"phase 13 K1a {name!r}: not applicable")
            continue
        got = k1.fused_iter_moments_ablate(*args, ablate=name)
        again = k1.fused_iter_moments_ablate(*args, ablate=name)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"K1a {name!r}: reruns differ")
        if hop in ("", "nomask", "nofold"):
            require(torch.equal(got.view(torch.int32), prod.view(torch.int32)),
                    f"K1a {name!r}: not the production K1's moments bit for bit")
        else:
            require(bool(torch.isfinite(got).all()), f"K1a {name!r}: non-finite moments")
            require(not torch.equal(got, prod), f"K1a {name!r}: equal to the full variant")
        log(f"phase 13 K1a {name!r} (Hopper {hop!r}) on 2x{H}x{W}: max |diff| from production "
            f"K1 {float((got - prod).abs().max()):.4g}")
    # (b) The full variant at the bench's batch 16 against the plain K1 and
    # the production K1, then attr_bench.run() as a user runs it.
    args = bench_args(16)
    full = k1.fused_iter_moments_ablate(*args, ablate="")
    ref = k1.fused_iter_moments_ref(*args)
    torch.cuda.synchronize()
    require(torch.equal(full.view(torch.int32), k1.fused_iter_moments(*args).view(torch.int32)),
            "K1a full at batch 16: not the production K1's moments bit for bit")
    err1a = float((full - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    require(err1a / scale <= KERNEL_TOL, f"K1a full: normalized err {err1a / scale}")
    log(f"phase 13 K1a full 16x{H}x{W} vs plain K1: max abs err {err1a:.3g}, "
        f"normalized {err1a / scale:.3g}")
    t0 = time.perf_counter()
    rows, counts = window(attr_bench.run)
    print("attr_bench " + json.dumps(rows), flush=True)
    require(counts["fused_iter_ablate"] > 0 and counts["warp_floor"] > 0,
            f"attr_bench did not launch K1a and K5: {counts}")
    for name in attr_bench.VARIANTS:
        row = rows[name or "(full)"]
        require(("not_applicable" in row) == (attr_bench.HOPPER[name] is None)
                and ("not_applicable" in row or min(row["device_ms"], row["cold_device_ms"]) > 0),
                f"attr_bench row {name!r}: {row}")
    log(f"phase 13 attr_bench: {time.perf_counter() - t0:.1f} s, launches {counts}")
    kernels["fused_iter_ablate"] = dict(
        route="cuda",
        source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/fused_iter_ablate.cu",
        replaces="inverse_compositional_algorithm_tpu/ops/pallas/fused_iter.py:117",
        max_abs_err=err1a,      # the full variant, the one with a plain version
        ms=cuda_ms(lambda: k1.fused_iter_moments_ablate(*args, ablate=""), 50),
        device_ms=rows["(full)"]["device_ms"], cold_device_ms=rows["(full)"]["cold_device_ms"],
        plain_ms=cuda_ms(lambda: k1.fused_iter_moments_ref(*args), 10),
        library_ms=None)        # as K1: no PyTorch call fuses this chain
    bound(kernels["fused_iter_ablate"], nbytes(*args[:3], args[4]) + 16 * 5 * 64 * 4,
          16 * H * W * benchmarks.fused_iter_flops_per_pixel(C))
    del args, full, ref
    # (c) The stabilization walkthrough, as a user runs it on the card.
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "stabilize_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "examples", "stabilize_torch.py"))
    stab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stab)
    est, counts = window(lambda: stab.main(device="cuda"))
    _, jitter = stab.make_sequence(device="cpu")
    e = T.EUCLIDEAN
    err = corner_err(ica.pad_params(torch.tensor(est, device=dev), e),
                     ica.pad_params(torch.tensor(jitter[:, :3], device=dev), e), e, 288, 384)
    require(err <= CORNER_TOL_CPU, f"stabilize_torch: corner err vs the jitter {err} px")
    require(counts["fused_iter_moments"] > 0 and counts["warp_planar"] > 0,
            f"stabilize_torch did not launch K1 and K3: {counts}")
    log(f"phase 13 stabilize_torch: corner err vs ground-truth jitter {err:.3g} px, "
        f"launches {counts}")
    # (d) The reference-signature shims on 8 flagship-size pairs a fraction
    # of a pixel apart (single-scale shims need no pyramid), numpy input.
    p_gt = motion(T.EUCLIDEAN, B, H, W) * 0.25
    i1s = warp.bicubic_sample(base.expand(B, H, W, C), *ica.transform_grid(p_gt, e, H, W))
    i1n, i2n = i1s.cpu().numpy(), base.expand(B, H, W, C).cpu().numpy()
    for shim, quadratic in [(layers.InverseCompositional(), True),
                            (layers.RobustInverseCompositional(), False),
                            (layers.PyramidalInverseCompositional(), True)]:
        (p, _, _, iw), counts = window(lambda: shim((i1n, i2n)))
        what = type(shim).__name__
        require(p.is_cuda and p.shape == (B, 3) and iw.shape == (B, H, W, C), f"{what}: shapes")
        err = corner_err(ica.pad_params(p, e), p_gt, e)
        require(err <= CORNER_TOL_GT, f"{what}: corner err vs ground truth {err} px")
        require(counts["fused_iter_moments"] > 0 and counts["warp_planar"] > 0
                and (counts["weighted_moments"] > 0) == quadratic,
                f"{what} did not launch K1, K3 (and K4 when quadratic): {counts}")
        log(f"phase 13 layers.{what}: corner err vs ground truth {err:.3g} px, launches {counts}")

    for k in kernels:
        kernels[k]["launches"] = launches[k]
        require(launches[k] > 0, f"{k} was not launched by any entry point")
    order = ["fused_iter_moments", "warp_planar", "weighted_moments", "warp_floor",
             "fused_iter_ablate", "trip_update", "level_pack"]
    fields = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "device_ms",
              "cold_device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [dict(name=k, **{f: kernels[k][f] for f in fields})
                                  for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
