"""Runner object API + CLI entry surface (reference runner.py / main.py)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import reference_path
from pydnmfk_tpu import Runner


def test_runner_pynmf(tmp_path):
    r = Runner(init="rand", itr=300, norm="fro", method="mu",
               process="pyDNMF", timing_stats=True)
    out = r.run(grid=[1, 1], fpath=reference_path("data") + "/",
                ftype="mat", fname="wtsi",
                results_path=str(tmp_path) + "/", k=4)
    assert set(out) == {"W", "H", "err"}
    assert out["W"].shape == (96, 4)
    assert out["H"].shape == (4, 21)
    assert out["err"] < 0.2
    # timing stats CSV written when enabled
    assert os.path.exists(os.path.join(str(tmp_path), "Timing_stats.csv"))


def test_runner_pynmfk_poisson(tmp_path):
    """Poisson sampling path end-to-end (smaller sweep)."""
    r = Runner(init="rand", itr=300, norm="fro", method="mu",
               process="pyDNMFk", perturbations=4, sampling="poisson",
               sill_thr=0.6)
    out = r.run(grid=[1, 1], fpath=reference_path("data") + "/",
                ftype="mat", fname="wtsi",
                results_path=str(tmp_path) + "/", k_range=[2, 5])
    assert "nopt" in out and 2 <= out["nopt"] <= 5


def test_runner_rejects_bad_process():
    with pytest.raises(ValueError):
        Runner(process="bogus")


def test_runner_beyond_reference_knobs(tmp_path):
    """Beyond-reference knobs thread through the Runner: seed changes the
    init stream, tol stops early, solve_checkpoint_every persists chunks."""
    kw = dict(grid=[1, 1], fpath=reference_path("data") + "/",
              ftype="mat", fname="wtsi", k=4)
    base = dict(init="rand", itr=400, norm="fro", method="mu",
                process="pyDNMF")
    a = Runner(**base, seed=1).run(results_path=str(tmp_path / "a"), **kw)
    b = Runner(**base, seed=2).run(results_path=str(tmp_path / "b"), **kw)
    assert not np.allclose(np.asarray(a["W"]), np.asarray(b["W"]))
    # a loose tol must not break the result badly
    c = Runner(**base, tol=1e-4).run(results_path=str(tmp_path / "c"), **kw)
    assert c["err"] < 0.2
    short = {**base, "itr": 100}
    d = Runner(**short, solve_checkpoint_every=40).run(
        results_path=str(tmp_path / "d"), **kw)
    assert d["err"] < 0.25


def test_step_k(tmp_path):
    """step_k>1 sweeps only every other k (reference --step_k)."""
    r = Runner(init="rand", itr=200, norm="fro", method="mu",
               process="pyDNMFk", perturbations=3, sill_thr=0.6)
    out = r.run(grid=[1, 1], fpath=reference_path("data") + "/",
                ftype="mat", fname="wtsi",
                results_path=str(tmp_path) + "/", k_range=[2, 6], step_k=2)
    ks = sorted(int(d) for d in os.listdir(os.path.join(str(tmp_path),
                                                        "wtsi"))
                if d.isdigit())
    assert ks == [2, 4, 6]


def test_cli_subprocess(tmp_path):
    """Drive the real CLI in a subprocess (a tiny -c wrapper forces the CPU
    platform before the CLI starts)."""
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from pydnmfk_tpu.cli import main;"
        f"main(['--process','pyDNMF','--p_r','1','--p_c','1','--k','3',"
        f"'--fpath','{reference_path('data')}/','--ftype','mat',"
        f"'--fname','wtsi','--norm','fro','--method','mu','--itr','200',"
        f"'--results_path','{tmp_path}/'])"
    )
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "relative error" in out.stdout


def test_save_factors_flag(tmp_path):
    from pydnmfk_tpu import NMF, NMFConfig
    from pydnmfk_tpu.utils.io import read_factors
    rng = np.random.default_rng(0)
    A = rng.random((20, 10)).astype(np.float32)
    cfg = NMFConfig(k=2, itr=100, norm="fro", method="mu",
                    save_factors=True, results_path=str(tmp_path) + "/")
    W, H, err = NMF(cfg).fit(A)
    W2, H2 = read_factors(str(tmp_path), (1, 1), reg=False)
    np.testing.assert_allclose(np.asarray(W), W2)


def test_cli_seed_grid_parse():
    """--seed_grid='2,2' reaches NMFkConfig.seed_grid through the Runner."""
    from pydnmfk_tpu.cli import build_parser
    args = build_parser().parse_args(
        ["--p_r", "1", "--p_c", "1", "--seed_grid", "2,2"])
    assert args.seed_grid == "2,2"
    r = Runner(process="pyDNMFk", seed_grid=(2, 2))
    assert r.seed_grid == (2, 2)


def test_runner_seed_grid_changes_sampling(tmp_path):
    """seed_grid compat vs default sampling give different ensembles (the
    reference-MPI tiling is a real statistical change)."""
    from pydnmfk_tpu.config import NMFConfig, NMFkConfig
    from pydnmfk_tpu.models.nmfk import NMFk
    rng = np.random.default_rng(0)
    A = (rng.random((16, 4)) @ rng.random((4, 12))).astype(np.float32)
    outs = {}
    for tag, sg in [("tiled", (2, 2)), ("indep", None)]:
        cfg = NMFkConfig(
            nmf=NMFConfig(itr=40, norm="fro", method="mu", init="rand"),
            start_k=3, end_k=3, perturbations=3, noise_var=0.05,
            results_path=str(tmp_path / tag), fname="A", checkpoint=False,
            seed_grid=sg)
        m = NMFk(cfg)
        m.fit(A)
        outs[tag] = m.per_k_stats[3]["recon_err"]
    assert not np.allclose(outs["tiled"], outs["indep"])
