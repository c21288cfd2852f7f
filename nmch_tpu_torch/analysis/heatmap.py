"""Heatmap post-processing of exploration CSVs — the reference's L7.

The reference's ``heatmap.py`` reads the sweep CSV, pivots a value
column over (k, theta) per sigma and per method, and renders seaborn
heatmaps in sigma-groups (``heatmap.py:1-53``); ours does the same
pivot for any of the CSV's value columns (the sweep emits
``execution_time`` and ``err``; the reference's offline CSVs had a
``bias`` column) and saves PNGs instead of blocking on plt.show().
Cosmetics (layout, colormap, titles) are our own — the parity target
is the pivot/grouping, not the styling.

A copy of ``nmch_tpu/analysis/heatmap.py`` (it imports no JAX; the
port imports nothing of ``nmch_tpu``), for the CSVs of
``nmch_tpu_torch.explore``.

Run: ``python -m nmch_tpu_torch.analysis.heatmap sweep.csv --value err
--outdir plots/``.
"""

from __future__ import annotations

import argparse
import os


def load_sweep(path: str):
    import pandas as pd
    data = pd.read_csv(path)
    data.columns = data.columns.str.strip()
    for col in data.columns:
        if col != "method":
            data[col] = pd.to_numeric(data[col], errors="coerce")
    return data.dropna(subset=[c for c in ("k", "theta", "sigma")
                               if c in data.columns])


def plot_heatmaps(data, value: str = "err", outdir: str = ".",
                  group_count: int = 3):
    """One figure per (method, sigma-group); returns the file paths."""
    if value not in data.columns:
        cols = [c for c in data.columns if c != "method"]
        raise SystemExit(f"heatmap: column {value!r} not in the CSV; "
                         f"available: {', '.join(cols)}")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    paths = []
    for method in data["method"].unique():
        md = data[data["method"] == method]
        sigmas = sorted(md["sigma"].unique())
        group_size = max(1, len(sigmas) // group_count
                         + (1 if len(sigmas) % group_count else 0))
        groups = [sigmas[i:i + group_size]
                  for i in range(0, len(sigmas), group_size)]
        for gi, group in enumerate(groups):
            fig, axes = plt.subplots(
                1, len(group), figsize=(4.6 * len(group), 7.2),
                constrained_layout=True)
            if len(group) == 1:
                axes = [axes]
            for ax, sv in zip(axes, group):
                piv = md[md["sigma"] == sv].pivot_table(
                    index="k", columns="theta", values=value,
                    aggfunc="mean")
                sns.heatmap(piv, annot=False, cmap="cividis",
                            cbar_kws={"label": value}, ax=ax)
                ax.set_title(f"sigma = {sv:g} (vol of vol)")
                ax.set_xlabel("theta (long-run variance)")
                ax.set_ylabel("kappa (mean reversion)")
            fig.suptitle(
                f"{method.strip()} sweep — {value} over (kappa, theta) "
                f"per sigma [panel set {gi + 1}]", fontsize=15)
            out = os.path.join(
                outdir, f"{method.strip()}_{value}_group{gi + 1}.png")
            fig.savefig(out, dpi=120)
            plt.close(fig)
            paths.append(out)
    return paths


def run(argv=None) -> int:
    p = argparse.ArgumentParser(description="sweep CSV -> heatmap PNGs")
    p.add_argument("csv", help="CSV from nmch_tpu_torch.explore")
    p.add_argument("--value", default="err",
                   help="column to plot (err, execution_time, ...)")
    p.add_argument("--outdir", default=".")
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    data = load_sweep(args.csv)
    for path in plot_heatmaps(data, value=args.value, outdir=args.outdir):
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
