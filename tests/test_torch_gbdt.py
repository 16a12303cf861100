"""Port parity: cloudtik_tpu_torch.models.gbdt and the server's GBDT backend
against the JAX package.

The same binned data and labels through both `fit`s, on the CPU: every
split (feature and bin) equal and the leaves, base scores and predictions
within 1e-6, for the logistic, l2 and softmax objectives.  Forests cross
through the npz format both ways.  `gbdt_backend` answers `/v1/predict`
over HTTP as the JAX backend does on the same forest, and refuses a
forest saved without its bin edges.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import gbdt as JGB
from cloudtik_tpu.serve import server as JS
from cloudtik_tpu_torch.models import gbdt as TGB
from cloudtik_tpu_torch.serve import server as TS

# one intra-op thread, as every port CPU test
torch.set_num_threads(1)

CASES = {
    "logistic": dict(n_trees=6, depth=3, n_bins=16, learning_rate=0.3),
    "l2": dict(n_trees=6, depth=4, n_bins=32, learning_rate=0.2,
               objective="l2"),
    "softmax": dict(n_trees=5, depth=3, n_bins=16, learning_rate=0.3,
                    objective="softmax", n_classes=3),
}


def _data(objective, n=600, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    if objective == "logistic":
        y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    elif objective == "l2":
        y = (2.0 * X[:, 0] + np.sin(3 * X[:, 1])).astype(np.float32)
    else:
        y = (2 * (X[:, 0] > 0) + (X[:, 1] > 0)).clip(0, 2).astype(np.int32)
    return X, y


def _fit_both(name, seed=0):
    X, y = _data(CASES[name].get("objective", "logistic"), seed=seed)
    jcfg, tcfg = JGB.config(**CASES[name]), TGB.config(**CASES[name])
    edges = TGB.quantile_bins(X, tcfg.n_bins)
    Xb = TGB.apply_bins(X, edges)
    jf = JGB.fit(jnp.asarray(Xb), jnp.asarray(y), jcfg)
    tf = TGB.fit(Xb, y, tcfg, device="cpu")
    return X, Xb, y, edges, jcfg, tcfg, jf, tf


def test_config_and_binning_match_jax():
    assert TGB.config() == TGB.GBDTConfig() and \
        vars(TGB.config()) == vars(JGB.config())
    X, _ = _data("logistic")
    edges = TGB.quantile_bins(X, 32)
    np.testing.assert_array_equal(edges, JGB.quantile_bins(X, 32))
    np.testing.assert_array_equal(TGB.apply_bins(X, edges),
                                  JGB.apply_bins(X, edges))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_splits_equal_and_leaves_match_jax(name):
    _, Xb, _, _, jcfg, tcfg, jf, tf = _fit_both(name)
    assert sorted(tf) == sorted(jf)
    for key in ("split_feat", "split_bin"):
        assert tf[key].dtype == torch.int32
        np.testing.assert_array_equal(tf[key].numpy(), np.asarray(jf[key]))
    assert tuple(tf["leaf"].shape) == jf["leaf"].shape
    np.testing.assert_allclose(tf["leaf"].numpy(), np.asarray(jf["leaf"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf["base_score"].numpy(),
                               np.asarray(jf["base_score"]), rtol=1e-6)
    want = np.asarray(JGB.predict_proba(jf, jnp.asarray(Xb), jcfg))
    got = TGB.predict_proba(tf, Xb, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the splits are real: some node splits on a bin below never-right
    assert (tf["split_bin"] < tcfg.n_bins).any()


def test_grow_round_is_fit_s_first_round_and_reports_each_level():
    X, y = _data("softmax")
    cfg = TGB.config(**CASES["softmax"])
    Xb = TGB.apply_bins(X, TGB.quantile_bins(X, cfg.n_bins))
    forest = TGB.fit(Xb, y, cfg, device="cpu")
    base, targets = TGB.initial_scores(torch.as_tensor(y), cfg)
    scores = base.reshape(-1, 1).expand(*targets.shape).clone()
    gaps = []
    trees = TGB.grow_round(torch.as_tensor(Xb).long(), scores, targets, cfg,
                           gaps)
    for key in trees:
        assert torch.equal(trees[key], forest[key][0])
    assert [tuple(g.shape) for g in gaps] == [(3, 2 ** level)
                                              for level in range(3)]
    assert all((g >= 0).all() for g in gaps)


def test_a_threshold_off_by_one_bin_changes_predictions():
    """The splits-equal check's power: one root threshold moved by a bin
    moves the predictions of the rows in that bin past 1e-6."""
    _, Xb, _, _, _, tcfg, _, tf = _fit_both("logistic")
    moved = {k: v.clone() for k, v in tf.items()}
    moved["split_bin"][0, 0] -= 1
    a = TGB.predict_proba(tf, Xb, tcfg).numpy()
    b = TGB.predict_proba(moved, Xb, tcfg).numpy()
    assert np.abs(a - b).max() > 1e-3


@pytest.mark.parametrize("name", ["logistic", "softmax"])
def test_npz_round_trip_both_ways(name, tmp_path):
    _, Xb, _, edges, jcfg, tcfg, jf, tf = _fit_both(name, seed=2)
    # a JAX save read by the port
    JGB.save(str(tmp_path / "jax.npz"), jf, edges)
    loaded, got_edges = TGB.load(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(got_edges, edges)
    np.testing.assert_allclose(
        TGB.predict(loaded, Xb, tcfg).numpy(),
        np.asarray(JGB.predict(jf, jnp.asarray(Xb), jcfg)), rtol=1e-6,
        atol=1e-6)
    # a port save read by JAX
    TGB.save(str(tmp_path / "port.npz"), tf, edges)
    jloaded, jedges = JGB.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(jedges, edges)
    for key in tf:
        np.testing.assert_array_equal(np.asarray(jloaded[key]),
                                      tf[key].numpy())
    # without edges
    TGB.save(str(tmp_path / "bare.npz"), tf)
    assert TGB.load(str(tmp_path / "bare.npz"), device="cpu")[1] is None


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("name", ["logistic", "softmax"])
def test_gbdt_backend_answers_like_jax(name, tmp_path):
    X, Xb, _, edges, jcfg, tcfg, jf, _ = _fit_both(name, seed=3)
    path = str(tmp_path / "forest.npz")
    JGB.save(path, jf, edges)
    rows = X[:17].tolist()
    want = JS.gbdt_backend(path).endpoints["predict"]({"features": rows})
    server = TS.ServeServer([TS.gbdt_backend(path, device="cpu")],
                            host="127.0.0.1")
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        got = _post(url + "/v1/predict", {"features": rows})
        with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
            assert json.loads(r.read()) == {"models": ["gbdt"]}
    finally:
        server.stop()
    np.testing.assert_allclose(np.asarray(got["probabilities"]),
                               np.asarray(want["probabilities"]),
                               rtol=1e-6, atol=1e-6)
    direct = TGB.predict_proba(TGB.load(path, device="cpu")[0],
                               TGB.apply_bins(X[:17], edges), tcfg)
    assert got["probabilities"] == direct.numpy().tolist()


def test_gbdt_backend_refuses_a_forest_without_edges(tmp_path):
    _, _, _, _, _, _, jf, _ = _fit_both("logistic")
    path = str(tmp_path / "bare.npz")
    JGB.save(path, jf)
    with pytest.raises(ValueError, match="without bin edges"):
        JS.gbdt_backend(path)
    with pytest.raises(ValueError, match="without bin edges"):
        TS.gbdt_backend(path, device="cpu")
    with pytest.raises(ValueError, match="without bin edges"):
        TS.main(["--gbdt", path, "--device", "cpu", "--port", "0"])


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_gbdt_entry_points_default_to_the_card(no_cuda, tmp_path):
    X, y = _data("logistic", n=50)
    Xb = TGB.apply_bins(X, TGB.quantile_bins(X, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TGB.fit(Xb, y, TGB.config(n_trees=1, depth=1, n_bins=8))
    path = str(tmp_path / "f.npz")
    TGB.save(path, TGB.fit(Xb, y, TGB.config(n_trees=1, depth=1, n_bins=8),
                           device="cpu"), TGB.quantile_bins(X, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.main(["--gbdt", path, "--port", "0"])
