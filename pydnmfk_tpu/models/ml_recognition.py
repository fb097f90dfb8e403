"""MLP-based estimation of the latent dimension k from NMFk statistics.

Reference: pyDNMFk/MLFeatureRecognition.py + the sklearn-MLP JSON round-trip
in utils.py:393-460, implementing "A neural network for determination of
latent dimensionality in non-negative matrix factorization".  A pretrained
model ships with the reference at data/convolute7-model-mAM-p.json
(relu MLP 21 -> 300 -> 200 -> 100 -> softmax 7).

Re-design: instead of reconstructing an sklearn ``MLPClassifier`` object
from JSON, the forward pass is implemented directly (jax.numpy) from the
stored ``coefs_``/``intercepts_`` — sklearn-version independent and
jit-compatible.  Statistics assembly and the sliding-window voting scheme
follow the reference exactly (buildStatistics :35-69, predictStatistics
:72-100).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_PROPERTIES = ["minSilhouetteCoefficients", "AIC",
                      "avgSilhouetteCoefficients"]
ML_WINDOW = 7          # the pretrained model consumes 7-k windows


class MLPModel:
    """Inference-only MLP loaded from the reference's JSON serialization
    (keys: coefs_, intercepts_, params.activation, out_activation_)."""

    def __init__(self, coefs: List[np.ndarray], intercepts: List[np.ndarray],
                 activation: str = "relu", out_activation: str = "softmax",
                 classes: Optional[np.ndarray] = None):
        self.coefs = [np.asarray(c, dtype=np.float64) for c in coefs]
        self.intercepts = [np.asarray(b, dtype=np.float64) for b in intercepts]
        self.activation = activation
        self.out_activation = out_activation
        self.classes = (np.arange(self.coefs[-1].shape[1])
                        if classes is None else np.asarray(classes))

    @classmethod
    def from_json(cls, path: str) -> "MLPModel":
        with open(path) as f:
            d = json.load(f)
        classes = d.get("classes_")
        return cls(d["coefs_"], d["intercepts_"],
                   activation=d.get("params", {}).get("activation", "relu"),
                   out_activation=d.get("out_activation_", "softmax"),
                   classes=None if classes is None else np.asarray(classes))

    @classmethod
    def from_sklearn(cls, clf) -> "MLPModel":
        """Convert a trained sklearn MLPClassifier (reference
        serialize_deserialize_mlp consumes/produces these, utils.py:393-460)."""
        return cls(list(clf.coefs_), list(clf.intercepts_),
                   activation=clf.get_params().get("activation", "relu"),
                   out_activation=clf.out_activation_,
                   classes=np.asarray(clf.classes_))

    def to_json(self, path: str) -> None:
        """Write the reference-compatible JSON schema (the serialize side of
        utils.py:411-437: coefs_/intercepts_/out_activation_/classes_/
        params.activation + the _label_binarizer block the reference's
        deserializer requires), so models trained here load in the reference
        and vice versa."""
        classes = self.classes.tolist()
        d = {
            "meta": "mlp",
            "coefs_": [np.asarray(c).tolist() for c in self.coefs],
            "intercepts_": [np.asarray(b).tolist() for b in self.intercepts],
            "loss_": 0.0,
            "n_iter_": 0,
            "n_layers_": len(self.coefs) + 1,
            "n_outputs_": int(self.coefs[-1].shape[1]),
            "out_activation_": self.out_activation,
            "classes_": classes,
            "_label_binarizer": {
                "neg_label": 0, "pos_label": 1, "sparse_output": False,
                "y_type_": "binary" if len(classes) <= 2 else "multiclass",
                "sparse_input_": False,
                "classes_": classes,
            },
            "params": {"activation": self.activation},
        }
        with open(path, "w") as f:
            json.dump(d, f)

    def _act(self, x):
        if self.activation == "relu":
            return np.maximum(x, 0.0)
        if self.activation == "tanh":
            return np.tanh(x)
        if self.activation == "logistic":
            return 1.0 / (1.0 + np.exp(-x))
        if self.activation == "identity":
            return x
        raise ValueError(f"unknown activation {self.activation!r}")

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        h = np.asarray(X, dtype=np.float64)
        for W, b in zip(self.coefs[:-1], self.intercepts[:-1]):
            h = self._act(h @ W + b)
        z = h @ self.coefs[-1] + self.intercepts[-1]
        if self.out_activation == "softmax":
            z = z - z.max(axis=-1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=-1, keepdims=True)
        if self.out_activation == "logistic":
            return 1.0 / (1.0 + np.exp(-z))
        return z

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.classes[np.argmax(self.predict_proba(X), axis=-1)]


class MLFeatureTools:
    """API mirror of reference MLFeaturetools: scan a results dir of per-k
    results.npz files, build feature statistics, vote with a sliding-window
    MLP to predict k."""

    def __init__(self, target_dir: str, clf: MLPModel, mis_val: int = 1,
                 hit_val: int = 6, app_data: Optional[Dict] = None,
                 property_list: Sequence[str] = DEFAULT_PROPERTIES):
        self.target_dir = target_dir
        self.clf = clf
        self.mis_val = mis_val
        self.hit_val = hit_val
        self.app_data: Dict = {} if app_data is None else app_data
        self.property_list = list(property_list)

    def build_statistics(self):
        """Collect per-k stats (reference buildStatistics :35-69): AIC is
        min-max normalized; clusterSilhouetteCoefficients zero-padded to
        max k."""
        from ..utils.io import read_cluster_results
        ks = sorted(int(d) for d in os.listdir(self.target_dir)
                    if d.isdigit())
        if not ks:
            raise FileNotFoundError(
                f"no per-k result dirs under {self.target_dir}")
        self.app_data["k"] = np.array(ks)
        n = len(ks)
        max_k = max(ks)
        stats = ["AIC", "L_errDist", "avgErr",
                 "avgSilhouetteCoefficients"]
        for s in stats:
            self.app_data[s] = np.zeros(n)
        self.app_data["clusterSilhouetteCoefficients"] = np.zeros((n, max_k))
        self.app_data["minSilhouetteCoefficients"] = np.zeros(n)
        for i, k in enumerate(ks):
            f = read_cluster_results(os.path.join(self.target_dir, str(k)))
            sils = f["clusterSilhouetteCoefficients"]
            self.app_data["clusterSilhouetteCoefficients"][i, :k] = sils
            self.app_data["minSilhouetteCoefficients"][i] = sils.min()
            for s in stats:
                self.app_data[s][i] = float(f[s])
        aic = self.app_data["AIC"]
        rng = np.max(aic - np.min(aic))
        self.app_data["AIC"] = (aic - np.min(aic)) / (rng if rng else 1.0)
        return self.app_data

    def predict_statistics(self) -> int:
        """Sliding-window MLP voting (reference predictStatistics :72-100):
        each window predicts an offset 0..6 into itself; offset hits
        accumulate hit_val votes, out-of-range predictions penalize with
        mis_val; the highest-voted position wins (ties -> largest k)."""
        if not self.app_data:
            self.build_statistics()
        ks = self.app_data["k"]
        init_feat = ks[0]
        npreds = ks.shape[0] - ML_WINDOW
        if npreds <= 0:
            raise ValueError(
                f"need more than {ML_WINDOW} k values, have {ks.shape[0]}")
        windows = np.array([
            np.concatenate([self.app_data[p][i:i + ML_WINDOW]
                            for p in self.property_list])
            for i in range(npreds)])
        preds = self.clf.predict(windows).astype(np.int64)
        counts = np.zeros(npreds, dtype=np.int64)
        for i in range(npreds):
            if preds[i] == ML_WINDOW - 1:
                counts[i + ML_WINDOW - 1:] += self.mis_val
            elif preds[i] == 0:
                counts[:i + 1] += self.mis_val
            elif i + preds[i] < npreds:
                counts[i + preds[i]] += self.hit_val
        return int(np.nonzero(counts == counts.max())[0][-1] + init_feat)


def predict_k(results_dir: str, model_json: str, **kw) -> int:
    """One-call convenience: results dir + model JSON -> predicted k."""
    return MLFeatureTools(results_dir, MLPModel.from_json(model_json),
                          **kw).predict_statistics()


# ---------------------------------------------------------------------------
# Training (beyond the reference, which ships only a pretrained sklearn
# model + the JSON round-trip): a JAX/optax loop producing MLPModels in the
# same schema, so users can retrain the k-predictor on their own NMFk
# sweeps and the result still loads in the reference's deserializer
# (utils.py:438-460) and vice versa.
# ---------------------------------------------------------------------------
def build_training_windows(app_datas: Sequence[Dict],
                           true_ks: Sequence[int],
                           property_list: Sequence[str] = DEFAULT_PROPERTIES):
    """Turn labeled sweep statistics into (windows, offsets) training pairs.

    ``app_datas`` are build_statistics() dicts (one per sweep), ``true_ks``
    the known latent dimension of each.  Labels mirror the voting scheme's
    interpretation (predict_statistics): offset of the true k inside the
    window, clamped to 0 ("before this window") / ML_WINDOW-1 ("at or past
    its end")."""
    Xs, ys = [], []
    for app, kt in zip(app_datas, true_ks):
        ks = np.asarray(app["k"])
        npreds = ks.shape[0] - ML_WINDOW
        if npreds <= 0:
            raise ValueError(
                f"sweep over {ks.shape[0]} k values is shorter than the "
                f"{ML_WINDOW + 1} needed for one window")
        # label = INDEX offset of the true k inside the window (the voting
        # scheme consumes index offsets, not k-value differences — they
        # coincide only for step_k == 1 sweeps)
        kt_idx = int(np.searchsorted(ks, kt))
        for i in range(npreds):
            Xs.append(np.concatenate([np.asarray(app[p])[i:i + ML_WINDOW]
                                      for p in property_list]))
            ys.append(int(np.clip(kt_idx - i, 0, ML_WINDOW - 1)))
    return np.asarray(Xs, np.float64), np.asarray(ys, np.int64)


def train_mlp(X, y, hidden: Sequence[int] = (300, 200, 100),
              activation: str = "relu", epochs: int = 300,
              batch_size: int = 32, learning_rate: float = 1e-3,
              alpha: float = 1e-4, seed: int = 0,
              verbose: bool = False) -> MLPModel:
    """Train a softmax-output MLP classifier in JAX (adam + L2, sklearn's
    MLPClassifier defaults: glorot-uniform init, alpha-weighted ridge) and
    return it as an inference/serialization-ready MLPModel."""
    import jax
    import jax.numpy as jnp
    import optax

    X = np.asarray(X, np.float32)
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    n, d = X.shape
    n_cls = classes.shape[0]
    sizes = [d, *hidden, n_cls]

    key = jax.random.key(seed)
    params = []
    for i in range(len(sizes) - 1):
        key, kw = jax.random.split(key)
        bound = np.sqrt(6.0 / (sizes[i] + sizes[i + 1]))
        W = jax.random.uniform(kw, (sizes[i], sizes[i + 1]), jnp.float32,
                               -bound, bound)
        params.append((W, jnp.zeros((sizes[i + 1],), jnp.float32)))

    act = {"relu": jax.nn.relu, "tanh": jnp.tanh,
           "logistic": jax.nn.sigmoid, "identity": lambda x: x}[activation]

    def forward(params, x):
        for W, b in params[:-1]:
            x = act(x @ W + b)
        W, b = params[-1]
        return x @ W + b

    def loss_fn(params, xb, yb):
        logits = forward(params, xb)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, yb)
        l2 = sum(jnp.sum(W * W) for W, _ in params)
        return jnp.mean(ce) + 0.5 * alpha * l2 / xb.shape[0]

    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)
    bs = min(batch_size, n)
    n_batches = n // bs

    @jax.jit
    def epoch(params, opt_state, key):
        perm = jax.random.permutation(key, n)[:n_batches * bs]
        xb = jnp.asarray(X)[perm].reshape(n_batches, bs, d)
        yb = jnp.asarray(y_idx)[perm].reshape(n_batches, bs)

        def step(carry, batch):
            params, opt_state = carry
            l, g = jax.value_and_grad(loss_fn)(params, *batch)
            updates, opt_state = opt.update(g, opt_state)
            return (optax.apply_updates(params, updates), opt_state), l

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), (xb, yb))
        return params, opt_state, jnp.mean(losses)

    for e in range(epochs):
        key, ke = jax.random.split(key)
        params, opt_state, l = epoch(params, opt_state, ke)
        if verbose and (e % 50 == 0 or e == epochs - 1):
            print(f"epoch {e}: loss {float(l):.4f}")

    return MLPModel([np.asarray(W, np.float64) for W, _ in params],
                    [np.asarray(b, np.float64) for _, b in params],
                    activation=activation, out_activation="softmax",
                    classes=classes)


def train_k_predictor(result_dirs: Sequence[str], true_ks: Sequence[int],
                      property_list: Sequence[str] = DEFAULT_PROPERTIES,
                      **train_kw) -> MLPModel:
    """End-to-end retraining: NMFk sweep result dirs + known true k per
    sweep -> trained window classifier usable by MLFeatureTools /
    predict_k (and by the reference, via MLPModel.to_json)."""
    apps = []
    for d in result_dirs:
        tool = MLFeatureTools(d, clf=None, property_list=property_list)
        apps.append(dict(tool.build_statistics()))
    X, y = build_training_windows(apps, true_ks, property_list)
    return train_mlp(X, y, **train_kw)
