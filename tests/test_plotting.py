"""Plotting smoke tests (Agg backend): every artifact renders."""
import os

import numpy as np

from pydnmfk_tpu.utils import plotting


def test_plot_err(tmp_path):
    out = str(tmp_path / "err.png")
    plotting.plot_err(np.geomspace(1, 1e-3, 50), out)
    assert os.path.getsize(out) > 0


def test_plot_w(tmp_path):
    rng = np.random.default_rng(0)
    out = str(tmp_path / "w.png")
    plotting.plot_W(rng.random((64, 4)), out)
    assert os.path.getsize(out) > 0


def test_selection_plot_from_results(tmp_path):
    ks = [2, 3, 4]
    for k in ks:
        d = tmp_path / str(k)
        d.mkdir()
        np.savez(str(d / "results.npz"), L_err=np.full(10, 1.0 / k),
                 avgErr=1.0 / k,
                 clusterSilhouetteCoefficients=np.ones(k) * 0.9)
    plotting.plot_results_fpath(str(tmp_path), ks, name="t")
    assert os.path.getsize(str(tmp_path / "t_selection_plot.pdf")) > 0


def test_box_plot(tmp_path):
    rng = np.random.default_rng(1)
    plotting.box_plot([rng.random(20), rng.random(20)], str(tmp_path))
    assert os.path.getsize(str(tmp_path / "box_plot.png")) > 0


def test_timing_stats_parse(tmp_path):
    import pandas as pd
    csv = str(tmp_path / "Timing_stats.csv")
    pd.DataFrame([{"read": 0.5, "solve": 2.0, "mystery": 0.1}]).to_csv(csv)
    cats, raw = plotting.timing_stats(csv)
    assert abs(cats["data_io"] - 0.5) < 1e-12
    assert abs(cats["dist_compute"] - 2.0) < 1e-12
    assert abs(cats["other"] - 0.1) < 1e-12
    assert raw["solve"] == 2.0


def test_timing_plot(tmp_path):
    import pandas as pd
    csv = str(tmp_path / "Timing_stats.csv")
    pd.DataFrame([{"read": 0.5, "solve": 2.0}]).to_csv(csv)
    plotting.plot_timing_stats(csv, str(tmp_path))
    assert os.path.getsize(str(tmp_path / "timing.png")) > 0
