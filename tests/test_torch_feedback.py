"""Graph SLAM with frontend feedback in the saturated regime, and the
snapshot replay that compares a saved run with either package
(``tests/_feedback_probe.py``).

The loop tour (200 scans, chunks of 32, ``min_gap`` 3) with a keyframe
store of 17: the store fills at scan 150, inside the chunk whose closures
feed back, so the feedback re-anchors the frontend on the store's last
keyframe while the frontend's own last keyframe lies further on
(``_rebuild_frontend``'s ``new_last`` and ``old_last`` are different
keyframes). Both packages do that alike: the same chunk records, the same
path bit for bit up to that feedback and within 1e-5 after it (it
re-anchors on optimized keyframes, which the graph parity tests hold
within 1e-3; here they differ by about 1e-6), and the same jump of the
path after it.
"""

import numpy as np

import _torch_util  # noqa: F401  (caps torch's threads)
from _feedback_probe import replay, run, save

N_SCANS, CHUNK, MIN_GAP, MAX_KF = 200, 32, 3, 17
PATH_TOL = 1e-5    # the submap-graph parity test's
GRAPH_TOL = 1e-3   # the graph parity tests' keyframe tolerance


def _run(package):
    return run(package, "loop", N_SCANS, CHUNK, MAX_KF, MIN_GAP, 1)


def test_saturated_store_feedback_matches_jax():
    tpath, gt, tg, tlog, _ = _run("torch")
    jpath, _, jg, jlog, _ = _run("jax")
    assert tg.saturated_at == jg.saturated_at == 150
    assert tg._kf_count == jg._kf_count == MAX_KF
    fed = [r["first_scan"] for r in tlog if r["feedback"]]
    assert fed == [r["first_scan"] for r in jlog if r["feedback"]]
    # a feedback in the chunk the store filled in, after it filled
    assert any(f <= tg.saturated_at < f + CHUNK for f in fed)
    keys = ("first_scan", "keyframes", "made", "closures", "weak",
            "feedback")
    assert [[r[k] for k in keys] for r in tlog] == \
        [[r[k] for k in keys] for r in jlog]
    for a, b in zip(tlog, jlog):
        assert (a["delta"] is None) == (b["delta"] is None)
        if a["delta"] is not None:
            assert abs(a["delta"] - b["delta"]) <= GRAPH_TOL
    assert tg.closures == jg.closures and tg.path_epoch == jg.path_epoch
    first = fed[0] + CHUNK   # the first scan after the feedback
    assert np.array_equal(tpath[:first], jpath[:first])
    np.testing.assert_allclose(tpath, jpath, atol=PATH_TOL, rtol=0)
    np.testing.assert_allclose(np.stack(tg.kf_poses), np.stack(jg.kf_poses),
                               atol=GRAPH_TOL, rtol=0)
    # the re-anchoring moved the frontend back to the store's last keyframe
    store_last, front_last, pose, after = tg.feedbacks[0]
    np.testing.assert_allclose(jg.feedbacks[0], tg.feedbacks[0],
                               atol=GRAPH_TOL, rtol=0)
    assert np.hypot(*(front_last - store_last)[:2]) > 0.5
    assert np.hypot(*(after - store_last)[:2]) < np.hypot(
        *(pose - store_last)[:2]) - 0.5
    err = np.hypot(*(tpath[:, :2] - gt[:, :2]).T)
    assert err[:first].max() < 0.05 < 0.3 < err[first:].max()


def test_replay_of_a_snapshot_equals_the_saved_run(tmp_path):
    """A saved run's snapshot of the chunk that feeds back (its starting
    frontend state and its optimize's graph) fed to each package on the
    CPU gives the saved chunk's path bit for bit and its optimize within
    1e-3."""
    fname = str(tmp_path / "loop.npz")
    path, gt, gs, log, _ = run("torch", "loop", 160, CHUNK, 512, MIN_GAP, 1,
                               snapshot=129)
    assert gs.snapshot["delta"] > 0.01
    save(fname, path, gt, gs, log)
    for package in ("torch", "jax"):
        out = replay(fname, package)
        assert f"max |{package} - saved| 0.000e+00 m" in out, out
        got = float(out.rsplit("max |", 1)[1].split("| ")[1])
        assert got <= GRAPH_TOL, out
