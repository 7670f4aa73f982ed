"""The comparison that decides `correct`: what the window's calls produced
against the plain reference, on pairs sampled from the seed.

For every pool batch the sample is `check_pairs` pairs drawn from the seed
and the pair that took the most finest-level iterations in the batch's
first call of the window. The reference (the module the configuration
names under benchmark/reference/) aligns the sampled pairs from the same
uint8 inputs in float64 and warps them; its candidates are matched to the
program's answers. Numbers compared, each against its limit in
benchmark/limits/<cell>.json:

- p_gap_px: the largest distance between the frame's corners mapped by the
  program's p and by the nearest reference candidate, over every call of
  the window and every sampled pair;
- iw_gap, di_gap: the largest |Iw - Iw_ref| and |DI - DI_ref| (grey
  levels) over the pixels valid on both sides, first call of each batch;
- valid_mismatch: sampled pixels whose valid flag differs from the
  reference's though the reference's sampling point lies farther than
  the p_gap_px limit from the edge of the domain; an exact comparison,
  limit 0 (a flag may flip only where the answers' own gap can move the
  point across the edge);
- diverged_mismatch: sampled (call, pair) whose divergence flag differs
  from the reference's; an exact comparison, limit 0;
- precision_drift: calls (warm-up, window, traced window) after which
  torch's float32 precision flags differ from those that set-up set from
  the configuration's `tf32`; limit 0. No answer of the program tells
  TF32 products from float32 ones apart (PERF.md), so the flags are held
  to the configuration directly.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import torch

from .harness import HERE, Run

NAMES = ("p_gap_px", "iw_gap", "di_gap", "valid_mismatch", "diverged_mismatch",
         "precision_drift")


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())


def readings(run: Run, edge_px: float, dtype=torch.float64) -> dict:
    """{name: value} of the numbers compared (module docstring); `edge_px`
    is the p_gap_px limit."""
    cfg = run.cell.config
    ref_mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    t = cfg["transform"]
    h, w = run.cell.mix["height"], run.cell.mix["width"]
    out = dict.fromkeys(NAMES, 0.0)
    out["precision_drift"] = float(run.precision_drift)
    for k, batch in enumerate(run.pool):
        s = run.samples[k]
        pairs, pos = np.unique(s.idx.numpy(), return_inverse=True)
        sel = torch.as_tensor(pairs, device=batch.i1.device)
        ref = ref_mod.align_ref(batch.i1[sel], batch.i2[sel], cfg, dtype=dtype)
        rp = ref.p.cpu()
        rpair = ref.pair.cpu()
        rdiv = ref.diverged.cpu()
        best = None
        for call in (c for c in run.calls if c.batch == k):
            p = torch.from_numpy(call.host[pairs, :8]).double()
            gap = ref_mod.corner_gap_px(p[rpair], rp, t, h, w)
            per_pair = torch.full((len(pairs),), float("inf"), dtype=torch.float64)
            per_pair = per_pair.scatter_reduce(0, rpair, gap, "amin")
            out["p_gap_px"] = max(out["p_gap_px"], float(per_pair.max()))
            if best is None:   # the first call's nearest candidate of each pair
                best = torch.full((len(pairs),), -1, dtype=torch.long)
                for r in torch.argsort(gap, descending=True).tolist():
                    best[rpair[r]] = r
            div = torch.from_numpy(call.host[pairs, 8] > 0.5)
            out["diverged_mismatch"] += float((div != rdiv[best]).sum())
        rows = torch.as_tensor(best[pos], device=ref.iw.device)
        r_iw, r_di, r_valid = ref.iw[rows], ref.di[rows], ref.valid[rows]
        both = (s.valid & r_valid)[..., None].expand_as(s.iw)
        out["iw_gap"] = max(out["iw_gap"], _gap(s.iw, r_iw, both))
        out["di_gap"] = max(out["di_gap"], _gap(s.di, r_di, both))
        gx, gy = ref_mod.grid(ref.p[rows], t, h, w)
        d = run.cell.config["delta"]
        edge = torch.stack([gx - d, (w - 1 - d) - gx, gy - d, (h - 1 - d) - gy]).abs().amin(0)
        far = (s.valid != r_valid) & (edge > edge_px)
        out["valid_mismatch"] += float(far.sum())
        del ref, r_iw, r_di, r_valid, gx, gy, edge
    return out


def _gap(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    if not bool(mask.any()):
        return 0.0
    d = (a.double() - b.double()).abs()[mask]
    return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")


def judge(values: dict, lims: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}): correct when every number is at or
    under its limit (a NaN is not)."""
    checks = {n: [values[n], lims[n]] for n in NAMES}
    return all(v <= lim for v, lim in checks.values()), checks
