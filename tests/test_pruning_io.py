"""Pruning round-trip (mirrors reference tests/test_dist_utils.py: inject
zero rows/cols into wtsi, prune, fit shape, unprune restores) and factor IO
round-trips."""
import os

import numpy as np
import pytest

from conftest import reference_path
from pydnmfk_tpu import NMF, NMFConfig
from pydnmfk_tpu.utils.io import DataReader, DataWriter, read_factors
from pydnmfk_tpu.utils.pruning import prune_all, unprune_factors, zero_masks


def wtsi():
    from scipy.io import loadmat
    return loadmat(reference_path("data", "wtsi.mat"))["X"].astype(np.float64)


def test_prune_unprune_roundtrip():
    A = wtsi()
    # inject zero rows/cols (reference test injects into wtsi)
    A[3, :] = 0
    A[:, 5] = 0
    A[40:42, :] = 0
    m, n = A.shape
    k = 3
    rng = np.random.default_rng(0)
    W, H = rng.random((m, k)), rng.random((k, n))

    Ap, Wp, Hp, st = prune_all(A, W, H)
    assert Ap.shape == (m - 3, n - 1)
    assert Wp.shape == (m - 3, k)
    assert Hp.shape == (k, n - 1)

    Wu, Hu = unprune_factors(Wp, Hp, st)
    assert Wu.shape == (m, k) and Hu.shape == (k, n)
    assert np.all(np.asarray(Wu)[3] == 0)
    assert np.all(np.asarray(Wu)[40:42] == 0)
    assert np.all(np.asarray(Hu)[:, 5] == 0)
    np.testing.assert_array_equal(np.asarray(Wu)[4], np.asarray(Wp)[3])


def test_nmf_with_pruning_converges():
    rng = np.random.default_rng(100)
    A = rng.random((24, 2)) @ rng.random((2, 12))
    A[7, :] = 0
    A[:, 3] = 0
    cfg = NMFConfig(k=2, itr=1000, norm="fro", method="mu", prune=True,
                    precision="float64")
    W, H, err = NMF(cfg).fit(A)
    assert W.shape == (24, 2) and H.shape == (2, 12)
    assert np.all(np.asarray(W)[7] == 0)
    assert np.all(np.asarray(H)[:, 3] == 0)
    assert err < 1e-3


def test_zero_masks_no_zeros():
    A = np.ones((4, 5))
    rm, cm = zero_masks(A)
    assert rm.all() and cm.all()


def test_data_reader_mat_and_chunks(tmp_path):
    from scipy.io import savemat
    X = np.random.default_rng(2).random((96, 21))
    savemat(str(tmp_path / "wtsi.mat"), {"X": X})
    r = DataReader(str(tmp_path) + "/", "wtsi", "mat", pgrid=(2, 1),
                   precision="float64")
    full = r.read_global()
    assert full.shape == (96, 21)
    np.testing.assert_array_equal(full, X)
    c0, c1 = r.read_chunk(0), r.read_chunk(1)
    assert c0.shape == (48, 21) and c1.shape == (48, 21)
    np.testing.assert_array_equal(np.vstack([c0, c1]), full)


@pytest.mark.parametrize("pgrid", [(1, 1), (2, 1), (1, 2), (2, 2), (2, 3)])
def test_factor_write_read_roundtrip(tmp_path, pgrid):
    rng = np.random.default_rng(1)
    W = rng.random((12, 3))
    H = rng.random((3, 10))
    w = DataWriter(str(tmp_path), pgrid)
    w.save_factors(W, H, reg=True)
    W2, H2 = read_factors(str(tmp_path), pgrid, reg=True)
    np.testing.assert_array_equal(W, W2)
    np.testing.assert_array_equal(H, H2)


def test_folder_roundtrip(tmp_path):
    from pydnmfk_tpu.utils.data_generator import generate_and_save
    shape = generate_and_save(20, 14, 3, (2, 2), str(tmp_path) + "/")
    r = DataReader(str(tmp_path) + "/", "X_", "folder", pgrid=(2, 2))
    full = r.read_global()
    assert full.shape == shape == (20, 14)
    # chunks must agree with the block partition of the global matrix
    from pydnmfk_tpu.parallel.partition import partition_slices
    for rank, sl in enumerate(partition_slices((2, 2), shape)):
        np.testing.assert_allclose(r.read_chunk(rank), full[sl], rtol=1e-6)
