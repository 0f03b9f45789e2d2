"""The port's metric measures and trackers against the JAX package.

* measures (per-sample sums of the PVE/MPJPE families, pose and shape
  MSE) on seeded numpy inputs: ≤ 1e-5 relative (fp32 sums and an fp32 SVD
  in another order);
* trackers on the inputs of ``tests/test_tracker.py``: the same history,
  the same save decisions, the same per-sample arrays, and a pickle that
  each package reads back from the other.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from soccerplayershapepose_tpu import metrics as jmetrics  # noqa: E402

from soccerplayershapepose_torch import metrics as tmetrics  # noqa: E402

REL = 1e-5
MEASURES = ("pve", "pve_sc", "pve_pa", "mpjpe", "mpjpe_sc", "mpjpe_pa")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n_points, seed):
    rng = np.random.RandomState(seed)
    target = rng.randn(4, n_points, 3).astype(np.float32)
    pred = (target * 1.3 + rng.randn(4, 1, 3).astype(np.float32)
            + 0.05 * rng.randn(4, n_points, 3).astype(np.float32))
    return pred, target


@pytest.mark.parametrize("name", MEASURES)
@pytest.mark.parametrize("n_points", [14, 6890])
def test_measure_matches_jax(name, n_points):
    pred, target = _points(n_points, seed=n_points)
    want = np.asarray(getattr(jmetrics, name)(jnp.asarray(pred),
                                              jnp.asarray(target)))
    got = getattr(tmetrics, name)(torch.from_numpy(pred),
                                  torch.from_numpy(target)).numpy()
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=REL)


def test_pose_and_shape_mse_match_jax():
    rng = np.random.RandomState(5)
    p, q = (rng.randn(3, 24, 3, 3).astype(np.float32) for _ in range(2))
    b, c = (rng.randn(3, 10).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tmetrics.pose_mse(torch.from_numpy(p), torch.from_numpy(q)).numpy(),
        np.asarray(jmetrics.pose_mse(jnp.asarray(p), jnp.asarray(q))),
        rtol=REL)
    np.testing.assert_allclose(
        tmetrics.shape_mse(torch.from_numpy(b), torch.from_numpy(c)).numpy(),
        np.asarray(jmetrics.shape_mse(jnp.asarray(b), jnp.asarray(c))),
        rtol=REL)


def _drive(mod, log_path=None):
    """The batches of tests/test_tracker.py through one package's trackers:
    (history, save decisions, eval final metrics, eval per-sample)."""
    t = mod.MetricsTracker(losses_to_track=["joints2D"],
                           metrics_to_track=["pves", "mpjpes",
                                             "joints2D_l2es"],
                           log_path=log_path)
    t.update_per_batch("train", loss=1.0, task_losses={"joints2D": 0.5},
                       metric_sums={"pves": 2 * 6890 * 0.01,
                                    "mpjpes": 2 * 14 * 0.1,
                                    "joints2D_l2es": 2 * 17 * 3.0},
                       num_samples=2)
    t.update_per_batch("train", loss=2.0, task_losses={"joints2D": 1.0},
                       metric_sums={"pves": 3 * 6890 * 0.01,
                                    "mpjpes": 3 * 14 * 0.1,
                                    "joints2D_l2es": 3 * 17 * 3.0},
                       num_samples=3)
    t.update_per_batch("val", loss=4.0, task_losses={"joints2D": 2.0},
                       metric_sums={"pves": 6890 * 0.02, "mpjpes": 14 * 0.2,
                                    "joints2D_l2es": 17 * 6.0},
                       num_samples=1)
    t.update_per_epoch()
    decisions = [t.determine_save_model_weights_this_epoch(
        ["pves", "mpjpes"], best) for best in (
            {"pves": np.inf, "mpjpes": np.inf},
            {"pves": 0.02, "mpjpes": 0.2},          # ties save
            {"pves": 0.03, "mpjpes": 0.1})]         # mpjpes regressed
    t.update_per_batch("val", 0.0, {}, {"pves": 6890 * 0.5,
                                        "mpjpes": 14 * 2.0}, 1)
    t.update_per_epoch()
    decisions.append(t.determine_save_model_weights_this_epoch(
        ["pves", "mpjpes"], {"pves": 1.0, "mpjpes": 1.0}))
    e = mod.EvalMetricsTracker(["pves", "mpjpes"])
    e.update_per_batch({"pves": np.array([6890 * 0.1, 6890 * 0.3]),
                        "mpjpes": np.array([14 * 0.5, 14 * 0.25])})
    e.update_per_batch({"pves": np.array([6890 * 0.2])})
    return t.history, decisions, e.final_metrics(), e.per_sample


def test_trackers_match_jax(tmp_path):
    jh, jd, jf, jps = _drive(jmetrics, str(tmp_path / "jax.pkl"))
    th, td, tf, tps = _drive(tmetrics, str(tmp_path / "torch.pkl"))
    assert th == jh
    assert td == jd == [True, True, False, False]
    assert tf == jf
    assert set(tps) == set(jps)
    for k in jps:
        assert len(tps[k]) == len(jps[k])
        for a, b in zip(tps[k], jps[k]):
            np.testing.assert_array_equal(a, b)
    # The pickled histories are the same bytes.
    with open(tmp_path / "jax.pkl", "rb") as f, \
            open(tmp_path / "torch.pkl", "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_tracker_pickle_round_trip(tmp_path, writer, reader):
    mods = {"jax": jmetrics, "torch": tmetrics}
    p = str(tmp_path / "logs.pkl")
    t = mods[writer].MetricsTracker([], ["pves"], log_path=p)
    for v in (1.0, 0.5, 0.25):
        t.update_per_batch("val", 0.0, {}, {"pves": 6890 * v}, 1)
        t.update_per_epoch()
    r = mods[reader].MetricsTracker([], ["pves", "mpjpes"])
    r.load(p, current_epoch=2)
    assert r.history["val_pves"] == [1.0, 0.5]
    assert r.history["val_mpjpes"] == [0.0, 0.0]
    r.save(str(tmp_path / "again.pkl"))
    back = mods[writer].MetricsTracker([], ["pves", "mpjpes"])
    back.load(str(tmp_path / "again.pkl"), current_epoch=2)
    assert back.history == r.history


def test_eval_tracker_saves_per_sample(tmp_path):
    e = tmetrics.EvalMetricsTracker(["pves", "mpjpes"])
    e.update_per_batch({"pves": np.array([6890 * 0.1, 6890 * 0.3])})
    e.save_per_sample(str(tmp_path / "out"))
    assert os.listdir(tmp_path / "out") == ["pves_per_frame.npy"]
    np.testing.assert_allclose(
        np.load(tmp_path / "out" / "pves_per_frame.npy"), [0.1, 0.3])
    assert np.isnan(e.final_metrics()["mpjpes"])
