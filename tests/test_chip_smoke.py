"""chip_smoke.py on the CPU: its plain reference agrees with the production
solve, and it refuses to run (non-zero exit, no result line) without a
GPU — here, and in a directory that holds nothing else of the repo."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("norm", ["fro", "kl"])
def test_plain_reference_matches_solve(norm):
    """The plain jax.numpy loop and models/nmf.solve run the same update
    rules, clip cadence and final normalize: on the CPU (true f32 dots)
    they agree to f32 summation order."""
    from pydnmfk_tpu.config import NMFConfig
    from pydnmfk_tpu.models import nmf as nmf_mod
    m, n, k, itr = 96, 64, 5, 30
    A = jnp.asarray(chip_smoke.planted_problem(m, n, k, seed=1))
    rng = np.random.default_rng(2)
    W0 = jnp.asarray(rng.random((m, k)), jnp.float32)
    H0 = jnp.asarray(rng.random((k, n)), jnp.float32)
    cfg = NMFConfig(k=k, itr=itr, norm=norm, method="mu")
    eps = jnp.float32(cfg.eps)
    W, H, err = nmf_mod.solve(A, W0, H0, eps, cfg)
    with jax.default_matmul_precision("highest"):
        Wr, Hr, err_r = chip_smoke.plain_nmf(A, W0, H0, eps, itr, norm)
    np.testing.assert_allclose(float(err), float(err_r), rtol=1e-5)
    assert chip_smoke.w_col_l1(W, Wr) < 1e-4
    np.testing.assert_allclose(np.asarray(H), np.asarray(Hr), rtol=1e-3,
                               atol=1e-5)


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code != 0


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_gpu(tmp_path, alone):
    """Run as the driver would: from the repo, and as a lone copy of the
    script.  Either way no GPU means a non-zero exit and no JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
