"""The port's training slice (jointpose_torch.train and the MRF kernels'
gradients) against the JAX reference, in fp32 on the CPU.

- ``make_lr`` against the optax schedules;
- the gradients of the fused epilogue, of the coarse ``impl='pallas'``
  pass and of the fused Fourier pass against JAX autodiff through the
  reference's custom VJPs (Pallas in interpret mode), odd windows only:
  the reference's ``pairwise_conv`` VJP is wrong for even windows;
- four mixed-stage steps of ``tiny`` against ``_make_step_body``, for
  both optimizers, with and without the detector freeze, with
  ``mrf_lr_mult=10``: this catches a per-parameter step count or a
  skipped zero-gradient update, which optax never does;
- one augmented step per warp, both sides fed the same AugmentParams;
- one augmented step of a joint-like ``tiny`` (max pools, the stride-1
  MRF over a (23, 31) window through the fused Fourier pass at 'high',
  the shear warp, crops of (0.8, 1.0)): the paper model's training path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose import train as jtrain
from jointpose.configs import get_config as jax_get_config
from jointpose.data import augment as ja
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.ops import mrf_fft_pallas as jmff
from jointpose.ops import mrf_pallas as jmp
from jointpose.ops import mrf_xla as jmx
from jointpose_torch import get_config
from jointpose_torch import train as ttrain
from jointpose_torch.convert import params_from_flax
from jointpose_torch.data import augment as ta
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.ops import mrf_epilogue as tme
from jointpose_torch.ops import mrf_fft_fused as tmff
from jointpose_torch.ops import mrf_xla as tmx

K = 9
HI = jax.lax.Precision.HIGHEST
# Gradients through fp32 conv stacks and DFT matmuls summed in another
# order, max|Δ| / max|ref| per tensor.
GRAD_RTOL = 1e-4
# Parameters after each step, max|Δ| / max(1, max|ref|) per tensor: one
# Adam update moves a parameter by up to lr·mrf_lr_mult = 3e-3, and the
# fp32 gradients differ by ~1e-6 relative, so 1e-5 is well inside one
# update while a skipped or mis-counted update misses by ~1e-3.
PARAM_TOL = 1e-5
LOSS_RTOL = 1e-5  # a few-thousand-term fp32 sum
NORM_RTOL = 1e-4  # the global norm of gradients that agree to GRAD_RTOL


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("schedule,mrf", [("constant", True), ("cosine", True), ("cosine", False)])
def test_make_lr_matches_optax(schedule, mrf):
    def cfg(get):
        c = get("tiny")
        c = c.replace(train=dataclasses.replace(c.train, lr_schedule=schedule, detector_steps=30,
                                                joint_steps=70, warmup_steps=8))
        return c if mrf else c.replace(mrf=None)

    want = jtrain.make_lr(cfg(jax_get_config))
    got = ttrain.make_lr(cfg(get_config))
    for count in (0, 1, 2, 5, 7, 8, 9, 20, 50, 99, 100, 150):
        w = float(want(count)) if callable(want) else want
        assert got(count) == pytest.approx(w, rel=1e-6, abs=1e-12), count
    if schedule == "cosine":
        assert got(0) == 0.0  # the first update under cosine has lr 0


def _mrf_inputs(hw, win, seed, batch=2):
    rs = np.random.RandomState(seed)
    p = rs.rand(batch, *hw, K).astype(np.float32)
    p /= p.sum(axis=(1, 2), keepdims=True)
    kernels = (rs.rand(*win, K, K) * 0.1).astype(np.float32)
    biases = (rs.rand(K, K) * 0.01 + 1e-4).astype(np.float32)
    return p, kernels, biases


def _grads_match(jfn, tfn, inputs, seed):
    out = jfn(*map(jnp.asarray, inputs))
    cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    want = jax.vjp(jfn, *map(jnp.asarray, inputs))[1](jnp.asarray(cot))
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    tfn(*ts).backward(torch.from_numpy(cot))
    for t, w in zip(ts, want):
        assert t.grad.dtype == t.dtype
        assert _rel(t.grad, w) <= GRAD_RTOL


def test_epilogue_vjp_matches_reference():
    p, kernels, biases = _mrf_inputs((5, 7), (3, 5), seed=0)
    resp = np.asarray(jmx.pairwise_conv(jnp.asarray(p), jnp.asarray(kernels), precision=HI))
    resp = resp.copy()
    # x = resp + bias at, just below and far below eps: the reference's
    # mask is x > eps, so all three get a zero gradient.
    biases[0, 0] = 0.0
    resp[0, 0, 0, 0, 0] = np.float32(1e-6)
    resp[0, 0, 1, 0, 0] = np.float32(5e-7)
    resp[0, 0, 2, 0, 0] = -1.0
    _grads_match(jmp.mrf_epilogue_pallas, tme.mrf_epilogue, (resp, biases), seed=1)
    g = torch.ones(resp.shape[:-2] + (K,))
    dresp, _ = tme.mrf_epilogue_bwd(torch.from_numpy(resp), torch.from_numpy(biases), g)
    assert (dresp[0, 0, :3, 0, 0] == 0).all()


def test_epilogue_bwd_plain_keeps_resp_dtype():
    p, kernels, biases = _mrf_inputs((4, 6), (3, 3), seed=2)
    resp = tmx.pairwise_conv(torch.from_numpy(p), torch.from_numpy(kernels)).bfloat16()
    g = torch.randn(resp.shape[:-2] + (K,))
    dresp, dbias = tme.mrf_epilogue_bwd(resp, torch.from_numpy(biases), g)
    assert dresp.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    # dbias sums the fp32 values, before the rounding of dresp to bf16.
    x = resp.float() + torch.from_numpy(biases)
    want = (g.unsqueeze(-2) / x).sum(dim=(0, 1, 2))
    assert _rel(dbias, want) <= 1e-6


def test_coarse_pallas_pass_grads_match_reference():
    inputs = _mrf_inputs((10, 14), (5, 7), seed=3)

    def jfn(p, k, b):
        return jmx.mrf_message_pass_coarse(p, k, b, stride=2, precision=HI,
                                           message_pass=jmp.mrf_message_pass_pallas)

    def tfn(p, k, b):
        return tmx.mrf_message_pass_coarse(p, k, b, stride=2,
                                           message_pass=tme.mrf_message_pass_pallas)

    _grads_match(jfn, tfn, inputs, seed=4)


def test_fused_fourier_pass_grads_match_reference():
    inputs = _mrf_inputs((6, 8), (5, 7), seed=5)
    jfn = lambda p, k, b: jmff.mrf_message_pass_fft_fused(p, k, b, 1e-6, HI)  # noqa: E731
    _grads_match(jfn, tmff.mrf_message_pass_fft_fused, inputs, seed=6)


def _tiny(get, **train):
    c = get("tiny")
    return c.replace(augment=dataclasses.replace(c.augment, enabled=False),
                     train=dataclasses.replace(c.train, mrf_lr_mult=10.0, **train))


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    b, (h, w) = cfg.train.batch_size, cfg.data.image_hw
    images = rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    joints = rs.uniform([2, 2], [w - 3, h - 3], (b, K, 2)).astype(np.float32)
    visible = (rs.rand(b, K) > 0.2).astype(np.float32)
    return ({"image": jnp.asarray(images), "joints": jnp.asarray(joints),
             "visible": jnp.asarray(visible)},
            {"image": torch.from_numpy(images), "joints": torch.from_numpy(joints),
             "visible": torch.from_numpy(visible)})


def _twin_states(jcfg, tcfg, mrf_noise=None):
    jstate = jtrain.create_state(jcfg, JaxPoseModel(jcfg), jax.random.PRNGKey(0))
    if mrf_noise is not None:  # the MRF's kernels and biases moved off their init
        rs = np.random.RandomState(mrf_noise)
        scale = {"raw_kernels": 1.0, "raw_bias": 0.5}

        def moved(path, x):
            s = scale.get(getattr(path[-1], "key", None))
            return x if s is None else x + s * rs.standard_normal(x.shape).astype(np.float32)

        jstate = jstate.replace(params=jax.tree_util.tree_map_with_path(moved, jstate.params))
    model = PoseModel(tcfg)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)))
    tstate = ttrain.TrainState(model, ttrain.make_optimizer(tcfg, model), 0,
                               torch.Generator().manual_seed(0))
    return jstate, tstate


def _assert_step_matches(jstate, jmet, tstate, tmet, what):
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = dict(tstate.model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        err = (got[name].detach() - w).abs().max().item() / max(1.0, w.abs().max().item())
        assert err <= PARAM_TOL, (what, name, err)
    assert set(tmet) == set(jmet)
    for key in ("loss", "detector_loss", "mrf_loss"):
        if key in jmet:
            assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=LOSS_RTOL), (what, key)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=NORM_RTOL), what
    assert tstate.step == int(jstate.step)


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("optimizer", ["adamw", "momentum"])
def test_mixed_stage_steps_match_reference(optimizer, freeze):
    kw = dict(optimizer=optimizer, freeze_detector_in_joint=freeze)
    jcfg, tcfg = _tiny(jax_get_config, **kw), _tiny(get_config, **kw)
    jbatch, tbatch = _batch(jcfg)
    jstate, tstate = _twin_states(jcfg, tcfg)
    detector_before = [p.detach().clone() for p in tstate.model.detector.parameters()]
    for i, stage in enumerate(("detector", "detector", "joint", "joint")):
        jstate, jmet = jax.jit(jtrain._make_step_body(jcfg, stage))(jstate, jbatch)
        tstate, tmet = ttrain.make_train_step(tcfg, stage)(tstate, tbatch)
        _assert_step_matches(jstate, jmet, tstate, tmet, f"step {i} ({stage})")
        if i == 1:
            detector_before = [p.detach().clone() for p in tstate.model.detector.parameters()]
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(detector_before, tstate.model.detector.parameters()))
    assert unchanged == freeze


@pytest.mark.parametrize("warp_impl", ["gather", "shear"])
def test_augmented_joint_step_matches_reference(warp_impl, monkeypatch):
    kw = dict(optimizer="adamw")
    jcfg, tcfg = _tiny(jax_get_config, **kw), _tiny(get_config, **kw)
    jcfg = jcfg.replace(augment=dataclasses.replace(
        jcfg.augment, enabled=True, warp_impl=warp_impl, crop_frac_range=(0.8, 1.0)))
    tcfg = tcfg.replace(augment=dataclasses.replace(
        tcfg.augment, enabled=True, warp_impl=warp_impl, crop_frac_range=(0.8, 1.0)))
    b = jcfg.train.batch_size
    draw = ja.random_augment_params(jax.random.PRNGKey(3), b, jcfg.augment, jcfg.data.image_hw)
    monkeypatch.setattr(jtrain, "random_augment_params", lambda *a: draw)
    tdraw = ta.AugmentParams(*(torch.from_numpy(np.array(x)) for x in draw))
    jbatch, tbatch = _batch(jcfg, seed=1)
    jstate, tstate = _twin_states(jcfg, tcfg)
    jstate, jmet = jax.jit(jtrain._make_step_body(jcfg, "joint"))(jstate, jbatch)
    tstate, tmet = ttrain.make_train_step(tcfg, "joint")(tstate, tbatch, aug=tdraw)
    _assert_step_matches(jstate, jmet, tstate, tmet, warp_impl)


def test_joint_like_step_matches_reference(monkeypatch):
    def cfg(get):
        c = _tiny(get, optimizer="adamw")
        return c.replace(mrf=dataclasses.replace(c.mrf, window=(23, 31), use_pallas=True),
                         augment=dataclasses.replace(c.augment, enabled=True, warp_impl="shear",
                                                     crop_frac_range=(0.8, 1.0)))

    jcfg, tcfg = cfg(jax_get_config), cfg(get_config)
    assert tcfg.detector.pool_mode == "max" and tcfg.mrf.stride == 1
    assert tcfg.mrf.precision == jcfg.mrf.precision == "high"
    draw = ja.random_augment_params(jax.random.PRNGKey(3), jcfg.train.batch_size, jcfg.augment,
                                    jcfg.data.image_hw)
    monkeypatch.setattr(jtrain, "random_augment_params", lambda *a: draw)
    tdraw = ta.AugmentParams(*(torch.from_numpy(np.array(x)) for x in draw))
    jbatch, tbatch = _batch(jcfg, seed=1)
    # At the init the MRF biases' gradients are rounding noise, which
    # Adam's first step scales up to a whole update: start off it.
    jstate, tstate = _twin_states(jcfg, tcfg, mrf_noise=2)
    recomputes = tmff._FusedPass.recomputes
    jstate, jmet = jax.jit(jtrain._make_step_body(jcfg, "joint"))(jstate, jbatch)
    tstate, tmet = ttrain.make_train_step(tcfg, "joint")(tstate, tbatch, aug=tdraw)
    assert tmff._FusedPass.recomputes - recomputes == 1
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    moments = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.opt_state[0][0].mu))
    got = dict(tstate.model.named_parameters())
    assert set(got) == set(want) == set(moments)
    group = tstate.optimizer.param_groups[0]
    # Adam's first update is lr·g/(|g| + eps): within a hundred eps of zero
    # it scales the gradients' rounding up to a good part of an update, so
    # a weight is held where its gradient (first moment / (1 - β1)) is above.
    floor = (1 - group["betas"][0]) * 100 * group["eps"]
    held_n = 0
    for name, w in want.items():
        m_ref, m_got = moments[name], tstate.optimizer.state[got[name]]["exp_avg"]
        assert _rel(m_got, m_ref) <= GRAD_RTOL, name
        held = m_ref.abs() >= floor
        held_n += int(held.sum())
        err = (got[name].detach() - w).abs()[held].max().item() / max(1.0, w.abs().max().item())
        assert err <= PARAM_TOL, (name, err)
    assert held_n > 0.9 * sum(w.numel() for w in want.values())
    assert set(tmet) == set(jmet)
    for key in ("loss", "detector_loss", "mrf_loss"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=LOSS_RTOL), key
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=NORM_RTOL)
    assert tstate.step == int(jstate.step)


def test_every_parameter_shares_one_step_count():
    """After a detector stage the spatial model, which the detector loss
    does not reach, has taken every update too: one Adam step count."""
    cfg = _tiny(get_config, optimizer="adamw")
    state = ttrain.create_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batch(cfg)
    for stage in ("detector", "detector", "joint"):
        state, _ = ttrain.make_train_step(cfg, stage)(state, batch)
    params = list(state.model.parameters())
    assert all(int(state.optimizer.state[p]["step"]) == 3 for p in params)


def test_init_mrf_from_priors_matches_reference():
    jcfg, tcfg = _tiny(jax_get_config), _tiny(get_config)
    jstate, tstate = _twin_states(jcfg, tcfg)
    wh, ww = tcfg.mrf.window
    priors = np.random.RandomState(0).rand(wh, ww, K, K).astype(np.float32)
    priors /= priors.sum(axis=(0, 1), keepdims=True)
    want = jtrain.init_mrf_from_priors(jstate, priors).params["spatial_model"]["raw_kernels"]
    got = ttrain.init_mrf_from_priors(tstate, priors).model.spatial_model.raw_kernels
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
