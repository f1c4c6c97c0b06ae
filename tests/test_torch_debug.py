"""The port's debug checks (``utils/debug``) on the cases of
``tests/test_debug.py``: a healthy state validates; an injected NaN, a
capacity overflow and a weight collapse are caught with the JAX package's
message substrings; ``checked`` catches a NaN in an output; a checked
``slam_step`` is clean; ``finite_or_revert`` reverts the whole tree."""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_util  # noqa: F401  (caps torch's threads)
from lidar_slam_tpu.utils import debug as jdebug
from lidar_slam_tpu_torch.config import DEFAULT_CONFIG, ParticleConfig
from lidar_slam_tpu_torch.io import simulate
from lidar_slam_tpu_torch.models import fastslam, scan_matcher
from lidar_slam_tpu_torch.utils import debug


def _state():
    ranges, _ = simulate.generate_dataset(n_scans=21, seed=0)
    return scan_matcher.init_state(torch.as_tensor(ranges[0]),
                                   DEFAULT_CONFIG), ranges


def test_healthy_state_validates():
    state, _ = _state()
    assert debug.validate_state(state) == []


def test_injected_nan_is_caught():
    state, _ = _state()
    bad = state._replace(pose=torch.tensor([float("nan"), 0.0, 0.0]))
    violations = debug.validate_state(bad)
    assert violations == ["state.pose: 1 non-finite of 3"]
    with pytest.raises(AssertionError, match="non-finite"):
        debug.assert_valid(bad)


def test_capacity_violation_is_caught():
    state, _ = _state()
    bad = state._replace(pmap=state.pmap._replace(
        size=torch.tensor(state.pmap.xy.shape[0] + 5, dtype=torch.int32)))
    assert any("pmap.size" in v for v in debug.validate_state(bad))


def test_weight_collapse_is_caught():
    cfg = dataclasses.replace(DEFAULT_CONFIG,
                              particles=ParticleConfig(n_particles=8))
    ranges, _ = simulate.generate_dataset(n_scans=2, seed=0)
    ps = fastslam.init_particles(torch.as_tensor(ranges[0]), cfg)
    assert debug.validate_state(ps) == []      # the generator is skipped
    bad = ps._replace(logw=torch.full_like(ps.logw, -float("inf")))
    assert any("collapsed" in v for v in debug.validate_state(bad))


def test_negative_step_is_caught():
    state, _ = _state()
    assert debug.validate_state(state._replace(step=-1)) == [
        "state.step=-1 negative"]


def test_checked_catches_nan():
    def f(x):
        return {"y": torch.log(x - 2.0), "n": torch.ones(2, dtype=torch.int32)}

    g = debug.checked(f)
    np.testing.assert_allclose(g(torch.tensor(3.0))["y"].numpy(), 0.0,
                               atol=1e-6)
    with pytest.raises(RuntimeError, match=r"output\['y'\] has 1 nan"):
        g(torch.tensor(1.0))
    with pytest.raises(RuntimeError, match="1 inf"):
        g(torch.tensor(2.0))


def test_check_raises_on_false():
    debug.check(torch.tensor([True, True]), "never")
    with pytest.raises(RuntimeError, match="pose 3 is off"):
        debug.check(torch.tensor([True, False]), "pose {i} is off", i=3)


def test_checked_slam_step_is_clean():
    """Twenty checked museum steps: outputs and states stay finite."""
    state, ranges = _state()
    angles = scan_matcher.angles_tensor(DEFAULT_CONFIG, "cpu")
    step = debug.checked(scan_matcher.slam_step)
    for t in range(1, 21):
        state, pose = step(state, torch.as_tensor(ranges[t]), DEFAULT_CONFIG,
                           angles)
    assert debug.validate_state(state) == []
    assert np.isfinite(pose.numpy()).all()


def test_finite_or_revert():
    """The JAX package's case, and its answer on the same numbers."""
    good = {"a": torch.ones(3), "b": torch.zeros(2)}
    bad = {"a": torch.tensor([1.0, float("nan"), 2.0]), "b": torch.zeros(2)}
    old = {"a": torch.full((3,), 7.0), "b": torch.full((2,), 7.0)}
    out = debug.finite_or_revert(good, old)
    np.testing.assert_allclose(out["a"].numpy(), 1.0)
    out = debug.finite_or_revert(bad, old)
    np.testing.assert_allclose(out["a"].numpy(), 7.0)   # whole-tree revert
    np.testing.assert_allclose(out["b"].numpy(), 7.0)
    import jax.numpy as jnp

    want = jdebug.finite_or_revert({k: jnp.asarray(v.numpy())
                                    for k, v in bad.items()},
                                   {k: jnp.asarray(v.numpy())
                                    for k, v in old.items()})
    for k in want:
        assert np.array_equal(out[k].numpy(), np.asarray(want[k]))


def test_messages_match_jax_package():
    """The same injected faults give the same violation strings in both
    packages (the JAX state built from the same numpy scan)."""
    import jax.numpy as jnp

    from lidar_slam_tpu.models import scan_matcher as jsm

    ranges, _ = simulate.generate_dataset(n_scans=2, seed=0)
    js = jsm.init_state(jnp.asarray(ranges[0]), DEFAULT_CONFIG)
    ts = scan_matcher.init_state(torch.as_tensor(ranges[0]), DEFAULT_CONFIG)
    nan = float("nan")
    jbad = js._replace(pose=jnp.asarray([nan, 0.0, 0.0]),
                       pmap=js.pmap._replace(size=jnp.int32(99999)))
    tbad = ts._replace(pose=torch.tensor([nan, 0.0, 0.0]),
                       pmap=ts.pmap._replace(size=torch.tensor(99999)))
    assert debug.validate_state(tbad) == jdebug.validate_state(jbad)
