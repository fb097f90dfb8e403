"""MLP k-predictor: forward-pass parity with sklearn on the reference's
pretrained JSON model, plus the voting scheme on synthetic statistics.

Mirrors reference tests/test_feature_recognition.py (manual/not-in-CI
there; automated here with synthetic per-k results)."""
import json
import os

import numpy as np
import pytest

from conftest import reference_path
from pydnmfk_tpu.models.ml_recognition import (MLFeatureTools, MLPModel,
                                               predict_k)
from pydnmfk_tpu.utils.io import DataWriter

MODEL_JSON = "data/convolute7-model-mAM-p.json"


def test_forward_pass_matches_sklearn():
    """Our numpy forward pass must reproduce sklearn MLPClassifier inference
    for the committed pretrained model."""
    path = reference_path(MODEL_JSON)
    model = MLPModel.from_json(path)
    rng = np.random.default_rng(0)
    X = rng.random((32, 21))

    # independently deserialize into sklearn and compare
    from sklearn.neural_network import MLPClassifier
    with open(path) as f:
        d = json.load(f)
    clf = MLPClassifier(hidden_layer_sizes=d["params"]["hidden_layer_sizes"],
                        activation=d["params"]["activation"])
    clf.coefs_ = [np.array(c) for c in d["coefs_"]]
    clf.intercepts_ = [np.array(b) for b in d["intercepts_"]]
    clf.n_layers_ = d["n_layers_"]
    clf.n_outputs_ = d["n_outputs_"]
    clf.out_activation_ = d["out_activation_"]
    clf.classes_ = np.array(d["classes_"])
    from sklearn.preprocessing import LabelBinarizer
    lb = LabelBinarizer()
    lb.classes_ = np.array(d["_label_binarizer"]["classes_"])
    lb.y_type_ = d["_label_binarizer"]["y_type_"]
    lb.sparse_input_ = d["_label_binarizer"]["sparse_input_"]
    clf._label_binarizer = lb

    np.testing.assert_allclose(model.predict_proba(X),
                               clf.predict_proba(X), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(model.predict(X), clf.predict(X))


def _write_results(tmp_path, ks, true_k):
    """Synthetic per-k results.npz: silhouettes collapse after true_k."""
    for k in ks:
        d = os.path.join(str(tmp_path), str(k))
        os.makedirs(d, exist_ok=True)
        sils = np.ones(k) if k <= true_k else np.concatenate(
            [np.ones(true_k), 0.2 * np.ones(k - true_k)])
        err = 1.0 / min(k, true_k) + (0.001 * k)
        DataWriter(d).save_cluster_results({
            "clusterSilhouetteCoefficients": sils,
            "avgSilhouetteCoefficients": sils.mean(),
            "L_err": np.full(10, err), "L_errDist": err, "avgErr": err,
            "recon_err": np.full(4, err),
            "AIC": -1000.0 / min(k, true_k)})


def test_build_statistics_shapes(tmp_path):
    ks = range(1, 12)
    _write_results(tmp_path, ks, true_k=4)
    model = MLPModel.from_json(reference_path(MODEL_JSON))
    t = MLFeatureTools(str(tmp_path), model)
    data = t.build_statistics()
    assert data["k"].tolist() == list(ks)
    assert data["clusterSilhouetteCoefficients"].shape == (11, 11)
    assert data["AIC"].min() == 0.0 and data["AIC"].max() == 1.0
    assert data["minSilhouetteCoefficients"][3] == 1.0
    assert data["minSilhouetteCoefficients"][10] == pytest.approx(0.2)


def test_predict_runs_end_to_end(tmp_path):
    ks = range(1, 15)
    _write_results(tmp_path, ks, true_k=5)
    pred = predict_k(str(tmp_path), reference_path(MODEL_JSON))
    # pretrained net was trained on real NMFk statistics; on synthetic
    # stats we only require a legal, in-range answer
    assert 1 <= pred <= 14


def test_too_few_ks_raises(tmp_path):
    _write_results(tmp_path, range(1, 6), true_k=3)
    model = MLPModel.from_json(reference_path(MODEL_JSON))
    with pytest.raises(ValueError, match="need more than"):
        MLFeatureTools(str(tmp_path), model).predict_statistics()


def test_mlp_json_roundtrip(tmp_path):
    """Serialize side of the reference's serialize_deserialize_mlp
    (utils.py:393-460): to_json -> from_json preserves predictions and the
    schema carries the keys the reference's deserializer requires."""
    import json
    import numpy as np
    from pydnmfk_tpu.models.ml_recognition import MLPModel

    rng = np.random.default_rng(7)
    model = MLPModel(
        coefs=[rng.normal(size=(5, 8)), rng.normal(size=(8, 3))],
        intercepts=[rng.normal(size=8), rng.normal(size=3)],
        activation="relu", out_activation="softmax",
        classes=np.array([0, 1, 2]))
    path = str(tmp_path / "mlp.json")
    model.to_json(path)

    with open(path) as f:
        d = json.load(f)
    for key in ("coefs_", "intercepts_", "out_activation_", "classes_",
                "_label_binarizer", "params", "n_layers_", "n_outputs_"):
        assert key in d
    assert d["params"]["activation"] == "relu"

    back = MLPModel.from_json(path)
    X = rng.normal(size=(4, 5))
    np.testing.assert_allclose(back.predict_proba(X),
                               model.predict_proba(X), rtol=1e-12)
    np.testing.assert_array_equal(back.predict(X), model.predict(X))


def test_mlp_from_sklearn_matches():
    """from_sklearn conversion bit-matches the sklearn forward pass."""
    import numpy as np
    sklearn = __import__("sklearn.neural_network", fromlist=["MLPClassifier"])
    from pydnmfk_tpu.models.ml_recognition import MLPModel

    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 5))
    y = rng.integers(0, 3, size=60)
    clf = sklearn.MLPClassifier(hidden_layer_sizes=(8,), max_iter=50,
                                random_state=0)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clf.fit(X, y)
    model = MLPModel.from_sklearn(clf)
    np.testing.assert_allclose(model.predict_proba(X), clf.predict_proba(X),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(model.predict(X), clf.predict(X))


# ---------------------------------------------------------------------------
# Training loop (beyond the reference, which ships only a pretrained model):
# JAX/optax trainer producing schema-compatible MLPModels
# ---------------------------------------------------------------------------
def test_train_mlp_learns_and_roundtrips(tmp_path):
    from pydnmfk_tpu.models.ml_recognition import train_mlp

    rng = np.random.default_rng(3)
    # three Gaussian blobs in 6-D with non-contiguous class labels
    n_per = 60
    X = np.concatenate([rng.normal(loc=4.0 * i, scale=0.5, size=(n_per, 6))
                        for i in range(3)])
    y = np.repeat([2, 5, 9], n_per)
    model = train_mlp(X, y, hidden=(16,), epochs=120, batch_size=16, seed=1)
    acc = np.mean(model.predict(X) == y)
    assert acc > 0.95
    assert model.classes.tolist() == [2, 5, 9]
    # the trained model serializes to the reference JSON schema and back
    path = str(tmp_path / "trained.json")
    model.to_json(path)
    back = MLPModel.from_json(path)
    np.testing.assert_array_equal(back.predict(X), model.predict(X))


def test_train_k_predictor_end_to_end(tmp_path):
    """Retrain the window classifier on synthetic labeled sweeps and verify
    the voting scheme recovers the planted k on a held-out sweep."""
    from pydnmfk_tpu.models.ml_recognition import (MLFeatureTools,
                                                   train_k_predictor)

    train_dirs, true_ks = [], []
    for i, kt in enumerate([3, 4, 5, 6, 7, 8]):
        d = tmp_path / f"sweep{i}"
        _write_results(d, range(1, 15), true_k=kt)
        train_dirs.append(str(d))
        true_ks.append(kt)
    model = train_k_predictor(train_dirs, true_ks, hidden=(32,),
                              epochs=200, batch_size=8, seed=0)

    held = tmp_path / "held"
    _write_results(held, range(1, 15), true_k=5)
    pred = MLFeatureTools(str(held), model).predict_statistics()
    assert pred == 5


def test_training_labels_are_index_offsets():
    """Labels are INDEX offsets into the window (what the voting scheme
    consumes), not k-value differences — they differ for step_k != 1."""
    from pydnmfk_tpu.models.ml_recognition import (DEFAULT_PROPERTIES,
                                                   build_training_windows)
    app = {"k": np.arange(2, 20, 2)}          # ks = 2,4,...,18 (step 2)
    for p in DEFAULT_PROPERTIES:
        app[p] = np.zeros(9)
    X, y = build_training_windows([app], [8])  # true k=8 -> index 3
    assert y.tolist() == [3, 2]                # npreds = 9-7 = 2 windows
