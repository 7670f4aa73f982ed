"""Plot a sweep record of eval/run_eval.py (reference `plot_results` parity).

The reference's evaluator renders per-sweep bar charts of accuracy and
time (test/ica_keras_performance_tests_colab.ipynb, `plot_results`); this
renders every sweep of a recorded JSON, as the JAX package's eval/plots.py
does. matplotlib is imported at first use.

Run:  python -m inverse_compositional_algorithm_tpu_torch.eval.plots EVAL.json [outdir]
"""

from __future__ import annotations

import json
import os
import sys

__all__ = ["plot_record", "main"]


def plot_record(record: dict, outdir: str = "eval_plots") -> list[str]:
    """Write one PNG per sweep (MAE, max error, pairs/s) into `outdir`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    written = []
    labels_by_sweep = {
        "robust_losses": lambda r: r["robust"],
        "pyramid_levels": lambda r: str(r["nscales"]),
    }
    for sweep, rows in record.get("sweeps", {}).items():
        label_of = labels_by_sweep.get(sweep, lambda r: r["transform"])
        labels = [label_of(r) for r in rows]
        fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
        for ax, key, title, log in (
            (axes[0], "mae", "parameter MAE", True),
            (axes[1], "max_err", "parameter max error", True),
            (axes[2], "pairs_per_sec", "throughput [pairs/s]", False),
        ):
            ax.bar(labels, [r[key] for r in rows], color="#4878a8")
            ax.set_title(title)
            if log:
                ax.set_yscale("log")
            ax.tick_params(axis="x", rotation=30)
            ax.grid(True, axis="y", alpha=0.3)
        conv = min(r["converged_frac"] for r in rows)
        fig.suptitle(f"{sweep} sweep — min converged_frac {conv:.2f} "
                     f"({record.get('device', '?')})")
        fig.tight_layout()
        path = os.path.join(outdir, f"{sweep}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        written.append(path)
        print(f"wrote {path}")
    return written


def main(argv=None) -> list[str]:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("usage: python -m inverse_compositional_algorithm_tpu_torch"
                         ".eval.plots EVAL.json [outdir]")
    outdir = argv[1] if len(argv) > 1 else "eval_plots"
    with open(argv[0]) as f:
        record = json.load(f)
    return plot_record(record, outdir)


if __name__ == "__main__":
    main()
