"""Hardware policy on the CPU: where the compile cache goes, how the device
memory budget is found, the per-device sparse cost table, the grid sparse
format, and that the NMFk sweep and CLI need none of the optional
packages (h5py, pandas, matplotlib, orbax, scikit-learn)."""
import contextlib
import csv
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest


class _FakeDevice:
    def __init__(self, stats=None, kind="cpu"):
        self._stats = stats
        self.device_kind = kind

    def memory_stats(self):
        return self._stats


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("env_set", [False, True])
def test_compilation_cache_placement(monkeypatch, restore_cache_dir,
                                     env_set):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and the code sets no
    directory of its own.  Unset: the fixed <checkout>/.jax_cache."""
    from pydnmfk_tpu import config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sentinel = "/nonexistent/cache-set-by-test"
    jax.config.update("jax_compilation_cache_dir", sentinel)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", sentinel)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    config.enable_compilation_cache()
    got = jax.config.jax_compilation_cache_dir
    assert got == (sentinel if env_set else os.path.join(repo, ".jax_cache"))


@pytest.mark.parametrize("case", ["stats", "env", "gpu_without_either"])
def test_device_memory_budget(monkeypatch, case):
    from pydnmfk_tpu.utils import memory
    monkeypatch.delenv("PYDNMFK_HBM_BUDGET", raising=False)
    if case == "stats":
        monkeypatch.setattr(jax, "local_devices", lambda: [
            _FakeDevice({"bytes_limit": 60 << 30})])
        assert memory.device_memory_budget() == 60 << 30
    elif case == "env":
        monkeypatch.setenv("PYDNMFK_HBM_BUDGET", "2e9")
        assert memory.device_memory_budget() == 2_000_000_000
    else:
        monkeypatch.setattr(jax, "local_devices",
                            lambda: [_FakeDevice(None, "Some GPU")])
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        with pytest.raises(RuntimeError, match="PYDNMFK_HBM_BUDGET"):
            memory.device_memory_budget()


def test_ell_time_model_known_kind_orders_formats():
    """Every table row orders the formats sensibly: a very sparse large
    matrix gathers faster than it streams dense, a dense-ish one does not."""
    from pydnmfk_tpu.ops.ell import SPARSE_COST_TABLE, ell_time_model
    assert SPARSE_COST_TABLE
    for kind, row in SPARSE_COST_TABLE.items():
        assert set(row) >= {"floor_s", "slot_s", "gather_Bps", "dense_Bps",
                            "source"}
        t_ell, t_dense = ell_time_model(100_000, 100_000, 2_000_000, 32,
                                        device_kind=kind)
        assert t_ell < t_dense
        t_ell, t_dense = ell_time_model(4096, 4096, 4096 * 1024, 32,
                                        device_kind=kind)
        assert t_ell > t_dense


@pytest.mark.parametrize("where", ["model", "densify"])
def test_unknown_device_kind_raises(monkeypatch, where):
    from pydnmfk_tpu.ops.ell import ell_time_model
    if where == "model":
        with pytest.raises(ValueError, match="Mystery Card"):
            ell_time_model(10, 10, 5, 4, device_kind="Mystery Card")
        return
    from jax.experimental import sparse as jsparse
    from pydnmfk_tpu.ops.sparse import densify_for_backend
    A = jsparse.BCOO.fromdense(jnp.eye(8, dtype=jnp.float32))
    monkeypatch.setenv("PYDNMFK_HBM_BUDGET", "1e9")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice(None, "Mystery Card")])
    with pytest.raises(ValueError, match="Mystery Card"):
        densify_for_backend(A)


@pytest.mark.parametrize("backend,fmt,want", [
    ("cpu", None, "triplet"),
    ("gpu", None, "triplet"),
    ("gpu", "ell", "ell"),
    ("cpu", "ELL", "ell"),
])
def test_grid_sparse_format(monkeypatch, backend, fmt, want):
    """The default grid format is the triplet on every backend (the GPU
    measurement in PERF.md); an explicit format is honored."""
    from pydnmfk_tpu.ops import sparse
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert sparse.grid_sparse_format(fmt) == want
    with pytest.raises(ValueError):
        sparse.grid_sparse_format("coo")


def test_sweep_and_cli_without_optional_packages(tmp_path, monkeypatch):
    """With h5py, pandas, matplotlib, orbax and scikit-learn unimportable
    the CLI's NMFk sweep still selects the planted rank: its per-k
    statistics live in results.npz, the reference-layout results.h5 is
    skipped, and the timing CSV is written with the csv module."""
    for name in ("h5py", "pandas", "matplotlib", "orbax", "sklearn"):
        monkeypatch.setitem(sys.modules, name, None)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import planted_problem
    from pydnmfk_tpu import cli
    A = planted_problem(64, 48, 3, seed=3, noise=0.0, disjoint=True)
    np.save(str(tmp_path / "planted.npy"), A)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.warns(UserWarning):
        cli.main(["--process=pyDNMFk", "--p_r=1", "--p_c=1", "--ftype=npy",
                  f"--fpath={tmp_path}/", "--fname=planted", "--norm=fro",
                  "--method=mu", "--itr=500", "--start_k=2", "--end_k=4",
                  "--perturbations=4", "--timing_stats=true",
                  f"--results_path={tmp_path}/res/"])
    assert "Rank estimated by NMFk = 3" in buf.getvalue()
    kdir = tmp_path / "res" / "planted" / "3"
    assert (kdir / "results.npz").exists()
    assert not (kdir / "results.h5").exists()
    with open(tmp_path / "res" / "Timing_stats.csv") as f:
        header, row = list(csv.reader(f))
    assert header[0] == "" and len(header) == len(row) > 1
