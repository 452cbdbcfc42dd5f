"""The port's numerics sanitizers (``jointpose_torch.debug``) through the
reference's four cases (tests/test_debug.py), and both packages flagging
the same NaN input on ``tiny``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose import debug as jax_debug
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose_torch import get_config
from jointpose_torch.convert import params_from_flax
from jointpose_torch.debug import assert_finite_tree, checked_apply
from jointpose_torch.models.pose import PoseModel


def test_checked_apply_clean_function():
    err, out = checked_apply(lambda x: torch.log(x + 1.0), torch.ones(4))
    err.throw()  # no error
    assert err.get() is None
    np.testing.assert_allclose(out.numpy(), np.log(2.0), rtol=1e-6)


def test_checked_apply_catches_nan():
    def bad(x):
        return torch.log(x)  # log(0) and log(-1): -inf and nan

    err, _ = checked_apply(bad, torch.tensor([-1.0, 0.0, 1.0]))
    with pytest.raises(FloatingPointError, match="bad"):
        err.throw()


def test_checked_apply_through_model():
    cfg = get_config("tiny")
    model = PoseModel(cfg)
    from jointpose_torch.predict import init_state_dict

    model.load_state_dict(init_state_dict(cfg, torch.Generator().manual_seed(0)))
    x = torch.from_numpy(np.random.RandomState(0).rand(1, *cfg.data.image_hw, 3).astype(np.float32))
    err, out = checked_apply(model.eval(), x)
    err.throw()
    assert "mrf_log_heatmaps" in out


def test_assert_finite_tree():
    assert_finite_tree({"a": torch.ones(2), "b": {"c": torch.zeros(())}})
    with pytest.raises(AssertionError, match="b/c"):
        assert_finite_tree({"a": torch.ones(2), "b": {"c": torch.tensor(float("nan"))}})
    with pytest.raises(AssertionError, match="t:l/1"):
        assert_finite_tree({"l": [np.ones(2), np.array([np.inf])]}, name="t")
    model = PoseModel(get_config("tiny"))
    state = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    assert_finite_tree(state)
    key = next(iter(state))
    state[key][...] = float("inf")
    with pytest.raises(AssertionError, match=f"state:{key}$"):
        assert_finite_tree(state, name="state")


def test_both_packages_flag_the_same_nan_input(tiny_config):
    jmodel = JaxPoseModel(tiny_config)
    x = np.random.RandomState(1).rand(2, *tiny_config.data.image_hw, 3).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = PoseModel(get_config("tiny"))
    model.load_state_dict(params_from_flax(params))
    model.eval()
    bad = x.copy()
    bad[1, 5, 7, 2] = np.nan
    jax_checked = jax.jit(lambda p, im: jax_debug.checked_apply(jmodel.apply, p, im))
    for images, flagged in ((x, False), (bad, True)):
        jerr, _ = jax_checked(params, jnp.asarray(images))
        err, _ = checked_apply(model, torch.from_numpy(images))
        assert (jerr.get() is not None) == (err.get() is not None) == flagged
    with pytest.raises(FloatingPointError, match="module 'detector.trunk.conv0'"):
        err.throw()
