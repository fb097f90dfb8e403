"""Invariants of the collective-structure study (docs/SCALING.md).

The study's load-bearing claims: per-iteration collective payloads are
factor-sized (O((m/p_r + n/p_c) k)), constant per device under weak
scaling, and KL adds no collective volume over FRO."""
import numpy as np


def _stats(grid, m, n, k, norm):
    import tools.scaling_study as ss
    return ss.step_stats(grid, m, n, k, norm)


def test_collective_structure_invariants():
    m, n, k = 96, 64, 4
    s1 = _stats((2, 1), m, n, k, "fro")
    assert s1["collective_ops"] >= 1
    # payload is factor-sized: well under one A block
    assert 0 < s1["collective_bytes"] < 4 * m * n // 2
    # ~(k*n + k*k) * 4 bytes for the combined W^T A + gram all-reduce
    assert s1["collective_bytes"] <= (k * n + 4 * k * k) * 4

    # KL adds HBM traffic, not collective volume
    s_kl = _stats((2, 1), m, n, k, "kl")
    assert s_kl["collective_bytes"] <= s1["collective_bytes"] * 1.5

    # weak scaling: fixed per-device block -> constant per-device payload
    w2 = _stats((2, 1), 2 * m, n, k, "fro")
    w4 = _stats((4, 1), 4 * m, n, k, "fro")
    assert w2["collective_bytes"] == w4["collective_bytes"]

    # 2D grids shrink the per-device payload vs 1D at the same p
    s2d = _stats((2, 2), m, n, k, "fro")
    assert s2d["per_dev_A_bytes"] == 4 * m * n // 4
