"""Plotting of factors, k-selection curves, and timing breakdowns.

Reference: pyDNMFk/plot_results.py.  Same artifact set: per-component factor
plots, the `<fname>_selection_plot.pdf` k-selection curve (Mean-L2 %,
relative-error %, minimum stability vs k read back from per-k results.npz),
and a timing bar chart.  Matplotlib is imported lazily with the Agg backend
so headless hosts work.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def plot_err(err: Sequence[float], out: str = "Error_plot.png"):
    """Relative error vs iteration (reference plot_err :7-15)."""
    plt = _plt()
    plt.figure()
    plt.plot(np.arange(1, len(err) + 1), err)
    plt.xlabel("Iterations")
    plt.ylabel("Relative error")
    plt.title("Relative error vs Iterations")
    plt.savefig(out)
    plt.close()


def plot_W(W, out: str = "Results_W.png"):
    """One subplot per latent component (reference plot_W :27-62)."""
    plt = _plt()
    W = np.asarray(W)
    m, k = W.shape
    f, axes = plt.subplots(nrows=k, sharex=True,
                           figsize=(12, max(2 * k, 4)), squeeze=False)
    for i in range(k):
        ax = axes[i][0]
        ax.plot(W[:, i], label=f"W[{i}]")
        ax.legend(loc=4)
    axes[-1][0].set_xlabel("Features")
    f.tight_layout()
    f.savefig(out, bbox_inches="tight")
    plt.close(f)


def read_plot_factors(factors_path: str, pgrid):
    from .io import read_factors
    W, H = read_factors(factors_path, pgrid)
    plot_W(W, os.path.join(factors_path, "W.png"))
    plot_W(H.T, os.path.join(factors_path, "H.png"))


def plot_results(ks, RECON, RECON1, SILL_MIN, out_dir: str, name: str):
    """k-selection twin-axis plot (reference plot_results :65-99)."""
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(10, 6), dpi=150)
    ax1.set_xlabel("Total Signatures")
    ax1.set_ylabel("Mean L2 %", color="tab:red")
    l1 = ax1.plot(ks, RECON, marker="o", linestyle=":", color="tab:red",
                  label="Mean L2 %")
    l3 = ax1.plot(ks, RECON1, marker="X", linestyle=":", color="tab:green",
                  label="Relative error %")
    ax1.tick_params(axis="y", labelcolor="tab:red")
    ax2 = ax1.twinx()
    ax2.set_ylabel("Minimum Stability", color="tab:blue")
    l2 = ax2.plot(ks, SILL_MIN, marker="s", linestyle="-.",
                  color="tab:blue", label="Minimum Stability")
    ax2.tick_params(axis="y", labelcolor="tab:blue")
    fig.tight_layout()
    lns = l1 + l2 + l3
    ax1.legend(lns, [l.get_label() for l in lns], loc=0)
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(os.path.join(out_dir, f"{name}_selection_plot.pdf"))
    plt.close(fig)


def plot_results_fpath(results_path: str, ks, name: str = None):
    """Same plot, reading each k's results.npz (reference :102-145 reads
    the same statistics from results.h5)."""
    from .io import read_cluster_results
    RECON, RECON1, SILL = [], [], []
    for k in ks:
        f = read_cluster_results(os.path.join(results_path, str(k)))
        RECON.append(float(np.mean(f["L_err"])))
        RECON1.append(float(f["avgErr"]))
        SILL.append(round(float(np.min(
            f["clusterSilhouetteCoefficients"])), 2))
    plot_results(list(ks), RECON, RECON1, SILL, results_path,
                 name or os.path.basename(results_path.rstrip("/")))


def box_plot(dat, respath: str):
    """Box plot of the column-error distribution (reference box_plot
    :147-154): one box per k, saved as box_plot.png in respath."""
    plt = _plt()
    plt.figure()
    plt.boxplot(dat)
    plt.xlabel("k")
    plt.ylabel("Column relative error")
    os.makedirs(respath, exist_ok=True)
    plt.savefig(os.path.join(respath, "box_plot.png"), bbox_inches="tight")
    plt.close()


def timing_stats(stats_csv: str):
    """Parse a Timing_stats.csv into the reference's two hierarchical
    breakdowns (reference timing_stats :157-201): a per-category dict
    (init / data_io / sampling / dist_compute / clustering / other) and
    the raw per-function dict."""
    import pandas as pd
    from .timing import CATEGORIES
    row = pd.read_csv(stats_csv).iloc[0]
    raw = {name: float(v) for name, v in row.items()
           if name not in ("Unnamed: 0",) and np.isreal(v)}
    cats = {c: 0.0 for c in CATEGORIES}
    other = 0.0
    for name, dt in raw.items():
        for cat, names in CATEGORIES.items():
            if name in names:
                cats[cat] += dt
                break
        else:
            other += dt
    cats["other"] = other
    return cats, raw


def plot_timing_stats(stats_csv: str, out_dir: str):
    """Bar chart of the category breakdown (reference :204-214)."""
    plt = _plt()
    import pandas as pd
    data = pd.read_csv(stats_csv).iloc[0, 1:]
    data.plot.bar()
    plt.xlabel("operation")
    plt.ylabel("timing(sec)")
    plt.savefig(os.path.join(out_dir, "timing.png"), bbox_inches="tight")
    plt.close()
