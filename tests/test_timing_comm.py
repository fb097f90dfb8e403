"""dist_comm timing category: collective op/byte accounting from compiled
HLO (the XLA analogue of the reference timing the MPI collectives
into its 'dist_comm' breakdown, plot_results.py:157-201)."""
import jax
import jax.numpy as jnp
import numpy as np

from pydnmfk_tpu.models import updates
from pydnmfk_tpu.parallel.mesh import GridContext, make_grid_mesh
from pydnmfk_tpu.utils import timing


def test_collective_stats_counts_psums():
    ctx = GridContext(make_grid_mesh(2, 2))
    rng = np.random.default_rng(0)
    A = jax.device_put(rng.random((32, 16)).astype(np.float32),
                       ctx.sharding_A)
    W = jax.device_put(rng.random((32, 4)).astype(np.float32),
                       ctx.sharding_W)
    H = jax.device_put(rng.random((4, 16)).astype(np.float32),
                       ctx.sharding_H)

    def step(A, W, H):
        return updates.mu_fro_step(A, W, H, jnp.float32(1e-7))

    stats = timing.collective_stats(step, A, W, H)
    # the FRO-MU step needs at least the two gram psums + two matvol
    # reductions (reference global_gram/ATW_glob/AH_glob collectives)
    assert sum(stats["counts"].values()) >= 2
    assert stats["bytes"] > 0


def test_record_dist_comm_category():
    timing.reset()
    timing.enable(True)
    try:
        ctx = GridContext(make_grid_mesh(2, 2))
        W = jax.device_put(np.ones((32, 4), np.float32), ctx.sharding_W)
        stats = timing.record_dist_comm(lambda w: w.T @ w, W,
                                        link_gbps=100.0)
        assert stats["est_seconds"] >= 0
        br = timing.category_breakdown()
        assert "dist_comm" in br
        # recorded under the _est-suffixed name: estimated, not measured
        assert "dist_comm" not in timing.TIMINGS
        assert br["dist_comm"] == timing.TIMINGS.get("dist_comm_est", 0.0)
    finally:
        timing.enable(False)
        timing.reset()


def test_single_device_has_no_collectives():
    stats = timing.collective_stats(lambda x: x @ x.T,
                                    jnp.ones((8, 8), jnp.float32))
    assert sum(stats["counts"].values()) == 0
    assert stats["bytes"] == 0
