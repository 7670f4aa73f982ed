#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`inverse_compositional_algorithm_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA device and nvcc. It builds the kernels from the sources in
this checkout, holds each kernel against its plain PyTorch version at the
flagship's shapes, drives `align()` end to end on 8 synthetic 584x388 RGB
pairs with known motion (HOMOGRAPHY + CHARBONNIER, lambda annealed 80 -> 5,
5 scales, then the default AlignConfig), checks that the main path went
through every kernel, and times it. Its last line is a JSON object with
"ok": true. It exits non-zero, without that line, when there is no CUDA
device or any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

B, H, W, C = 8, 388, 584, 3          # the flagship batch (eval/benchmarks.py:1-10)
COARSE = (25, 37)                    # its coarsest pyramid level
KERNEL_TOL = 2e-4                    # moments, normalized by max(|ref|, 1)
WARP_TOL = 2e-3                      # warp of 0..255 images, absolute
CORNER_TOL_GT = 0.1                  # px, align against the ground truth
CORNER_TOL_CPU = 1e-2                # px, CUDA align against the CPU plain align


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    from inverse_compositional_algorithm_tpu_torch.ops.kernels import (
        _build, fused_iter as k1, normal_eq as k4, warp as k3,
    )
    from inverse_compositional_algorithm_tpu_torch.ops.normal_equations import grad_moments
    from inverse_compositional_algorithm_tpu_torch.ops.transforms import transform_points

    T, R = ica.TransformType, ica.RobustLoss
    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1 card: {card}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {build_s:.2f} s (nvcc {_build.BUILD_INFO['seconds']:.2f} s, "
        f"compiled={_build.BUILD_INFO['compiled']})")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", file=sys.stderr)

    def cuda_ms(fn, n: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

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
        return torch.tensor(p, device=dev)

    kernels = {}

    # ---- phase 3: K3 warp ----
    def check_warp(img_p, gx, gy, what):
        got = k3.warp_planar(img_p, gx, gy)
        ref = k3.warp_planar_ref(img_p, gx, gy)
        torch.cuda.synchronize()
        require(torch.equal(torch.isnan(got), torch.isnan(ref)), f"K3 {what}: NaN positions differ")
        fin = ~torch.isnan(ref)
        err = float((got[fin] - ref[fin]).abs().max())
        require(err <= WARP_TOL, f"K3 {what}: max abs err {err} > {WARP_TOL}")
        log(f"phase 3 K3 {what}: max abs err {err:.3g}, NaN {float(torch.isnan(ref).float().mean()):.4f}")
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
        plain_ms=cuda_ms(lambda: k3.warp_planar_ref(img_p, gx, gy), 10))

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
        plain_ms=cuda_ms(lambda: k4.weighted_moments_ref(maps), 10))

    # ---- phase 5: K1 fused iteration ----
    def k1_case(h, w, delta):
        i1 = pyramid.gaussian_blur(rand_images(B, h, w), 2.0)
        i2 = pyramid.gaussian_blur(rand_images(B, h, w), 2.0)
        ix, iy = gradients.central_gradients(i1)
        band = gradients.boundary_band_mask(h, w, delta, device=dev)[None, :, :, None]
        ix, iy = ix * band, iy * band
        plan = k1.plan_fused_iter(i1, i2, ix, iy, *grad_moments(ix, iy), robust=True)
        gx, gy = ica.transform_grid(motion(T.HOMOGRAPHY, B, h, w), T.HOMOGRAPHY, h, w)
        return plan, gx, gy

    lam = torch.linspace(5.0, 80.0, B, device=dev)
    err1 = None
    for (h, w) in [(H, W), COARSE]:
        delta = min(10, (min(h, w) - 1) // 4)
        plan, gx, gy = k1_case(h, w, delta)
        for robust, nan in [(R.CHARBONNIER, True), (None, True), (R.CHARBONNIER, False)]:
            args = (plan.i2p, plan.tplp, gx, gy, lam, h, w, robust, nan, delta)
            err = check_moments(k1.fused_iter_moments(*args), k1.fused_iter_moments_ref(*args),
                                f"5 K1 {h}x{w} {robust.name if robust else 'QUADRATIC'} "
                                f"nanifoutside={nan}")
            if (h, w) == (H, W) and robust is not None and nan:
                err1 = err
                kernels["fused_iter_moments"] = dict(
                    route="cuda",
                    source="inverse_compositional_algorithm_tpu_torch/ops/kernels/csrc/fused_iter.cu",
                    replaces="inverse_compositional_algorithm_tpu/ops/pallas/fused_iter.py:312",
                    max_abs_err=err1,
                    ms=cuda_ms(lambda: k1.fused_iter_moments(*args), 50),
                    plain_ms=cuda_ms(lambda: k1.fused_iter_moments_ref(*args), 10))

    # ---- phase 6: the main path end to end ----
    base = pyramid.gaussian_blur(rand_images(1, H, W), 2.0)[0]

    def pairs(ttype):
        p_gt = motion(ttype, B, H, W)
        gx, gy = ica.transform_grid(p_gt, ttype, H, W)
        i1 = warp.bicubic_sample(base.expand(B, H, W, C), gx, gy)
        return i1, base.expand(B, H, W, C).contiguous(), p_gt

    cx = [0.0, W - 1.0, 0.0, W - 1.0]
    cy = [0.0, 0.0, H - 1.0, H - 1.0]

    def corner_err(pa, pb, ttype):
        ax, ay = transform_points(pa.double(), ttype, cx, cy)
        bx, by = transform_points(pb.double(), ttype, cx, cy)
        return float(torch.hypot(ax - bx, ay - by).max())

    modules = {"fused_iter_moments": k1, "warp_planar": k3, "weighted_moments": k4}
    flagship = ica.AlignConfig(transform=T.HOMOGRAPHY, robust=R.CHARBONNIER, lam=0.0,
                               nscales=5, nu=0.5, delta=10)
    default = ica.AlignConfig()
    runs = {}
    for name, cfg in [("flagship", flagship), ("default", default)]:
        i1, i2, p_gt = pairs(cfg.transform)
        for m in modules.values():
            m.LAUNCHES = 0
        res = ica.align(i1, i2, cfg)
        torch.cuda.synchronize()
        counts = {k: m.LAUNCHES for k, m in modules.items()}
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
    for k in kernels:
        kernels[k]["launches"] = fl[k] + de[k]

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

    order = ["fused_iter_moments", "warp_planar", "weighted_moments"]
    print(json.dumps({"kernels": [dict(name=k, **{f: kernels[k][f] for f in (
        "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")})
        for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
