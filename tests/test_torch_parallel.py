"""The port's process mesh and tensor parallelism (jointpose_torch.parallel)
against the JAX reference on the CPU.

One world of four processes (``python -m torch.distributed.run``, gloo)
runs every multi-process check once and writes its results; the tests
hold them against the reference's unsharded results computed here:

- ``make_mesh`` over the world (data-major coordinates, errors);
- the source-joint TP pass for n_model 2 (a 2x2 mesh) and 4 (1x4),
  forward, local shapes and the gradients of p, kernels and biases, odd
  windows only (the reference's even-window VJP is wrong, ADVICE.md);
- one data-parallel step (data 2, a mesh of ranks {0, 1} and one of
  {2, 3}), the same step with augmentation (the global draw sliced), one
  2x2 step and one 2x2 step with spatial parallelism (the trunk's rows over
  'model', halo exchanges), against the reference's one-device step on the
  same converted weights, at ``tests/test_parallel.py``'s tolerances;
- the same steps over data 2, 2x2 and 2x2 spatial on ``flagship``'s own
  MRF path in bf16 (``compute_dtype='bfloat16'``, 'auto' at stride 2 ->
  'xla': the grouped conv's autograd function, at model 2 on Kv 5 of the
  padded 10 sources a rank), against the port's one-device step, which is
  itself held against the reference's one-device bf16 step;
- ``evaluate(mesh=)`` on the 2x2 mesh (its model tensor-parallel, and also
  spatial) and on a data-4 mesh, with a ragged last batch, against the
  reference's ``evaluate``;
- ``evaluate.main`` under the launcher (--mesh-data 2 --mesh-model 2) on a
  written checkpoint, against ``evaluate.main`` in one process;
- the K-step dispatch over data 2, 2x2 and 2x2 spatial (``tiny``,
  augmentation on): ``make_train_multistep`` at K 3 and
  ``make_train_multistep_arrays`` at K 2 against 5 single steps, bit for
  bit (the eager form, the CPU's); and ``DispatchGraphs.run``'s decisions
  to warm, capture and replay, with a stub for the capture, when one
  rank's optimizer state is reloaded between two dispatches, and when one
  rank's capture fails.

``pad_source_axis`` and ``param_shardings`` need no world.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose import train as jtrain
from jointpose.configs import MeshConfig as JaxMeshConfig
from jointpose.configs import get_config as jax_get_config
from jointpose.data import augment as ja
from jointpose.data import pipeline as jpipe
from jointpose.losses import heatmap_loss, mrf_heatmap_loss
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.ops.mrf_xla import mrf_message_pass_xla as jax_pass
from jointpose.parallel import mesh as jmesh
from jointpose.parallel import mrf_tp as jtp
from jointpose import evaluate as jev
from jointpose_torch import evaluate as tev
from jointpose_torch.configs import MeshConfig, get_config
from jointpose_torch.convert import params_from_flax, write_initial_checkpoint
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.parallel import mesh as tmesh
from jointpose_torch.parallel import mrf_tp as ttp
from jointpose_torch.train import create_state, make_train_step

from test_torch_evaluate import _assert_evals_agree, _setup, _visible_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HI = jax.lax.Precision.HIGHEST
# tests/test_parallel.py:87-91: the sharded step against one device.
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-3, 2e-5
# tests/test_parallel.py's TP pass tolerance (atol 1e-5 on log-sums of
# a few tens); the gradients, of magnitude up to 1/bias, by max|Δ| / max|ref|
# as tests/test_torch_train.py's GRAD_RTOL.
TP_ATOL, TP_GRAD_RTOL = 1e-5, 1e-4
TP_GEOMETRY = {2: ((12, 16), (7, 9)), 4: ((10, 12), (5, 7))}  # n_model: (hw, odd window)
# flagship's own MRF path in bf16, one step: the loss by |Δ| / |ref| and the
# gradients by max|Δ| / max|ref| per tensor.  The sides round the same bf16
# conv stacks in other orders (a rank's rows, a slice of the sources, rows
# of the trunk, the reference's XLA): a few roundings of 2^-8 each.
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-3, 1e-2
# The port's one-device bf16 detector against the reference, by max|Δ| /
# max|ref| per tensor, held against the reference's fp32 gradients: a bf16
# forward rounds every activation, and on `tiny` each package's bf16
# gradients lie up to 2.4e-2 (the port) and 2.8e-2 (the reference's
# weights) from the fp32 ones.  The reference's bf16 bias gradients are no
# reference on the CPU: XLA's CPU backend sums their bf16 cotangent in bf16,
# 0.42 of the largest from its own fp32 gradients (the port sums in fp32).
# The MRF's gradients, where both packages run the same grouped conv and
# backward, are held against the reference's bf16 step at BF16_GRAD_RTOL.
BF16_DETECTOR_GRAD_RTOL = 5e-2
# Adam's first update is g / (|g| + eps), a sign where |g| >> eps.  A
# parameter whose one-device gradient is at least the gradient bar of its
# tensor's largest keeps its sign under any deviation within that bar, and
# is held at tests/test_parallel.py's tolerance.  Below it a deviation may
# flip the update: such parameters are held within one flipped update (2 lr
# and the atol), and at most BF16_FLIP_SHARE of all parameters may end
# beyond the tolerance (the fp32 sharded step's rule, ROADMAP.md queue 3, at the
# bf16 bar).
BF16_FLIP_SHARE = 1e-2

CHILD = r"""
import contextlib
import copy
import dataclasses
import sys
import types
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from jointpose_torch import evaluate as tev
from jointpose_torch.configs import MeshConfig, get_config
from jointpose_torch.data.augment import AugmentParams
from jointpose_torch.data.pipeline import from_host_arrays, make_dataset
from jointpose_torch.evaluate import evaluate
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.ops.mrf_xla import mrf_message_pass_xla
from jointpose_torch.parallel.mesh import Mesh, init_distributed, make_mesh, shard_batch, shard_state
from jointpose_torch.parallel.mrf_tp import mrf_message_pass_tp
from jointpose_torch.train import (create_state, make_train_multistep, make_train_multistep_arrays,
                                   make_train_step)

torch.set_num_threads(2)
data = sys.argv[1]
init_distributed("cpu")
rank = dist.get_rank()
out = {"rank": rank}

# make_mesh over the world of 4: shapes, coordinates, refusals.
for name, (d, m) in {"2x2": (-1, 2), "4x1": (4, 1), "1x4": (1, 4)}.items():
    mesh = make_mesh(MeshConfig(data=d, model=m))
    out["mesh", name] = (dict(mesh.shape), dict(mesh.coords))
for d, m in ((3, 2), (1, 1), (-1, 3)):
    try:
        make_mesh(MeshConfig(data=d, model=m))
        out["refused", d, m] = None
    except ValueError as e:
        out["refused", d, m] = str(e)

# The source-joint TP pass, n_model 2 on a 2x2 mesh and 4 on a 1x4 mesh.
tp = np.load(f"{data}/tp.npz")
for n in (2, 4):
    mesh = make_mesh(MeshConfig(data=-1, model=n))
    p, k, b = (torch.from_numpy(tp[f"{x}{n}"]).requires_grad_() for x in "pkb")
    r = torch.from_numpy(tp[f"r{n}"])
    shapes = []

    def recording(p_, k_, b_, **kw):
        shapes.append((tuple(p_.shape), tuple(k_.shape), tuple(b_.shape)))
        return mrf_message_pass_xla(p_, k_, b_, **kw)

    y = mrf_message_pass_tp(p, k, b, mesh=mesh, base_pass=recording)
    (y * r).sum().backward()
    # Kernels and biases are used in this rank's slice only: summed over
    # 'model', as the trainer sums such gradients.
    gk, gb = (mesh.all_reduce(t.grad.clone(), "model") for t in (k, b))
    out["tp", n] = (y.detach().numpy(), p.grad.numpy(), gk.numpy(), gb.numpy(), shapes[0])

# Training steps against one device: data 2 (two meshes of two ranks),
# the same with augmentation, and 2x2.
groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
g = groups[rank // 2]
dp = Mesh(2, 1, rank % 2, {None: g, "data": g}, "gloo")
init = torch.load(f"{data}/init.pt", weights_only=True)
batch = {k: torch.from_numpy(v) for k, v in np.load(f"{data}/batch.npz").items()}
draw = AugmentParams(*(torch.from_numpy(v) for v in np.load(f"{data}/draw.npz").values()))
base = get_config("tiny")
noaug = base.replace(augment=dataclasses.replace(base.augment, enabled=False),
                     train=dataclasses.replace(base.train, batch_size=8))
aug = noaug.replace(augment=dataclasses.replace(noaug.augment, enabled=True,
                                                crop_frac_range=(0.8, 1.0)))
spatial = noaug.replace(mesh=MeshConfig(data=2, model=2, spatial=True))
for name, cfg, mesh, with_draw in (("dp", noaug, dp, False), ("dp_aug", aug, dp, True),
                                   ("2x2", noaug, make_mesh(MeshConfig(data=2, model=2)), False),
                                   ("2x2_spatial", spatial, make_mesh(spatial.mesh), False)):
    state = create_state(cfg, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    state.model.load_state_dict(init)
    state = shard_state(state, mesh)
    step = make_train_step(cfg, "joint", mesh)
    state, metrics = step(state, shard_batch(batch, mesh), aug=draw if with_draw else None)
    out["step", name] = ({k: float(v) for k, v in metrics.items()},
                         {k: v.detach().numpy() for k, v in state.model.named_parameters()},
                         sorted(state.model.model_sliced_parameters()))

# flagship's own MRF path in bf16 ('auto' at stride 2 -> 'xla'): the
# grouped conv's autograd function, whose groups each call records.
from jointpose_torch.ops import mrf_xla

bf16 = noaug.replace(compute_dtype="bfloat16", mrf=dataclasses.replace(noaug.mrf, stride=2))
bf16_spatial = bf16.replace(mesh=MeshConfig(data=2, model=2, spatial=True))
function = mrf_xla.grouped_conv_f32
groups = []


def recording(p, kern, n):
    groups.append(n)
    return function(p, kern, n)


mrf_xla.grouped_conv_f32 = recording
init = torch.load(f"{data}/init_bf16.pt", weights_only=True)
for name, cfg, mesh in (("dp", bf16, dp), ("2x2", bf16, make_mesh(MeshConfig(data=2, model=2))),
                        ("2x2_spatial", bf16_spatial, make_mesh(bf16_spatial.mesh))):
    groups.clear()
    state = create_state(cfg, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    state.model.load_state_dict(init)
    state = shard_state(state, mesh)
    state, metrics = make_train_step(cfg, "joint", mesh)(state, shard_batch(batch, mesh))
    out["bf16_step", name] = ({k: float(v) for k, v in metrics.items()},
                              {k: v.detach().numpy() for k, v in state.model.named_parameters()},
                              {k: v.grad.numpy() for k, v in state.model.named_parameters()},
                              list(groups))
mrf_xla.grouped_conv_f32 = function

# evaluate(mesh=): the 2x2 mesh with its model tensor-parallel (and also
# spatial), and data 4.
arrays = dict(np.load(f"{data}/eval.npz"))
weights = torch.load(f"{data}/eval_weights.pt", weights_only=True)
cfg = get_config("tiny")
for name, mesh, sp in (("2x2", make_mesh(MeshConfig(data=2, model=2)), False),
                       ("2x2_spatial", make_mesh(MeshConfig(data=2, model=2)), True),
                       ("4x1", make_mesh(MeshConfig(data=4, model=1)), False)):
    model = PoseModel(cfg, mesh=mesh, spatial=sp)
    model.load_state_dict(weights)
    out["eval", name] = evaluate(model.eval(), from_host_arrays(arrays), cfg, mesh=mesh)

# The K-step dispatch over the meshes (the eager form, the CPU's): index-fed
# at K = 3 and array-fed at K = 2 against K single steps from one state.
kcfg = aug.replace(train=dataclasses.replace(aug.train, lr_schedule="cosine", detector_steps=2,
                                             joint_steps=8))
kmeshes = {"dp": (kcfg, dp),
           "2x2": (kcfg, make_mesh(MeshConfig(data=2, model=2))),
           "2x2_spatial": (kcfg.replace(mesh=MeshConfig(data=2, model=2, spatial=True)),
                           make_mesh(MeshConfig(data=2, model=2)))}
tb = kcfg.train.batch_size


def rank_rows(mesh, first, n):
    rows = tb // mesh.shape["data"]
    lo = mesh.coords["data"] * rows
    return np.stack([(np.arange(s * tb, (s + 1) * tb) % 16)[lo:lo + rows]
                     for s in range(first, first + n)])


def kstate(cfg, mesh):
    state = create_state(cfg, torch.Generator().manual_seed(5), device="cpu", mesh=mesh)
    return shard_state(state, mesh)


def snapshot(state, metrics):
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            [v.clone() for p in state.model.parameters()
             for v in state.optimizer.state[p].values()],
            {k: v.clone() for k, v in metrics.items()}, state.step,
            state.generator.get_state())


for name, (cfg, mesh) in kmeshes.items():
    ds = make_dataset(cfg.data, "cpu")[0]
    single, multi = kstate(cfg, mesh), kstate(cfg, mesh)
    step = make_train_step(cfg, "joint", mesh)
    for s in range(5):
        single, want = step(single, ds.get_batch(rank_rows(mesh, s, 1)[0]))
    multi, _ = make_train_multistep(cfg, "joint", ds.get_batch, 3, mesh)(
        multi, rank_rows(mesh, 0, 3))
    batches = [ds.get_batch(i) for i in rank_rows(mesh, 3, 2)]
    multi, got = make_train_multistep_arrays(cfg, "joint", 2, mesh)(
        multi, {k: torch.stack([b[k] for b in batches]) for k in batches[0]})
    out["kstep", name] = (snapshot(multi, got), snapshot(single, want))

# The recapture decision over the mesh: DispatchGraphs.run's flow on the
# CPU, where a stub stands for each captured graph (it records its capture
# and each of its replays, and runs nothing), and the optimizer holds its
# rates as 0-d tensors, as make_optimizer has them on the card.  Between
# two dispatches the optimizer state of the mesh's rank 1 is reloaded (new
# tensors, as from a checkpoint): every rank must warm the stage again,
# then capture alike.
from jointpose_torch import train as ttrain

events = []


fail_capture = False  # set where a rank's capture is to raise


class StubCapture:
    def __init__(self, pool, fn, generator=None):
        events[-1].append("capture")
        if fail_capture:
            raise RuntimeError("stub capture failed")
        self.out = {}

    def replay(self):
        events[-1].append("replay")


def card_rates(state):
    for group in state.optimizer.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]))
    return state


stream = types.SimpleNamespace(wait_stream=lambda other: None)
refresh = ttrain.DispatchGraphs.refresh


def recorded_refresh(self, state, mesh=None):
    events.append(["stale" if refresh(self, state, mesh) else "kept"])


with contextlib.ExitStack() as stack:
    for target, attr, value in (
            (ttrain, "graph_dispatch", lambda device, mesh=None: True),
            (ttrain, "Graph", StubCapture),
            (ttrain.DispatchGraphs, "refresh", recorded_refresh),
            (torch.cuda, "device", lambda device: contextlib.nullcontext()),
            (torch.cuda, "stream", lambda s: contextlib.nullcontext()),
            (torch.cuda, "Stream", lambda: stream),
            (torch.cuda, "current_stream", lambda: stream),
            (torch.cuda, "graph_pool_handle", lambda: None)):
        stack.enter_context(mock.patch.object(target, attr, value))
    for name, (cfg, mesh) in kmeshes.items():
        ds = make_dataset(cfg.data, "cpu")[0]
        state = card_rates(kstate(cfg, mesh))
        multi = make_train_multistep(cfg, "joint", ds.get_batch, 2, mesh)
        events.clear()
        for d in range(5):
            if d == 3 and mesh.rank == 1:
                opt = state.optimizer
                opt.load_state_dict(copy.deepcopy(opt.state_dict()))
                card_rates(state)
            state, _ = multi(state, rank_rows(mesh, 2 * d, 2))
        out["recapture", name] = [tuple(e) for e in events]
    # A capture that fails on the mesh's rank 1 raises on every rank.
    for name, (cfg, mesh) in kmeshes.items():
        ds = make_dataset(cfg.data, "cpu")[0]
        state = card_rates(kstate(cfg, mesh))
        multi = make_train_multistep(cfg, "joint", ds.get_batch, 2, mesh)
        state, _ = multi(state, rank_rows(mesh, 0, 2))
        fail_capture = mesh.rank == 1
        try:
            multi(state, rank_rows(mesh, 2, 2))
            raised = None
        except RuntimeError as e:
            raised = str(e)
        fail_capture = False
        out["capture_failure", name] = (mesh.rank, raised)

torch.save(out, f"{data}/rank{rank}.pt")
# evaluate.main over the launcher's world (it leaves the process group).
tev.main(["--config", "tiny", "--checkpoint", f"{data}/ckpt", "--step", "0", "--device", "cpu",
          "--mesh-data", "2", "--mesh-model", "2", "--json-out", f"{data}/eval_main.json"])
"""


def _tiny_noaug(get):
    c = get("tiny")
    return c.replace(augment=dataclasses.replace(c.augment, enabled=False),
                     train=dataclasses.replace(c.train, batch_size=8))


def _bf16_xla(cfg):
    """``cfg`` on flagship's own MRF path: bf16 compute, 'auto' at stride 2."""
    return cfg.replace(compute_dtype="bfloat16", mrf=dataclasses.replace(cfg.mrf, stride=2))


def _reference_loss_and_grads(jcfg, params, batch_j):
    """The reference's joint-stage loss and gradients (``jtrain._make_step_body``'s
    loss without augmentation), as numpy, the gradients by port name."""
    targets = jtrain._render_targets(jcfg, batch_j["joints"], batch_j["visible"])
    model = JaxPoseModel(jcfg)

    def loss(p):
        out = model.apply({"params": p}, batch_j["image"])
        return (heatmap_loss(jcfg.train.detector_loss, out["detector_logits"], targets,
                             batch_j["visible"])
                + mrf_heatmap_loss(jcfg.train.mrf_loss, out["mrf_log_heatmaps"], targets,
                                   batch_j["visible"]))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    grads = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    return float(value), {k: v.numpy() for k, v in grads.items()}


def _tp_inputs(n):
    hw, win = TP_GEOMETRY[n]
    k, b = 9, 4
    rs = np.random.RandomState(n)
    logits = rs.randn(b, hw[0] * hw[1], k)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    kernels = np.log1p(np.exp(rs.randn(*win, k, k)))
    biases = np.log1p(np.exp(rs.randn(k, k) - 4.0))
    # The loss is sum(out * r): a cotangent of unit order everywhere.
    r = rs.randn(b, *hw, k)
    return [x.astype(np.float32) for x in (p.reshape(b, *hw, k), kernels, biases, r)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Write the inputs, run the world of four, return its ranks' results
    and what the reference computes from the same inputs."""
    data = tmp_path_factory.mktemp("parallel")
    np.savez(data / "tp.npz", **{f"{x}{n}": v for n in TP_GEOMETRY
                                 for x, v in zip("pkbr", _tp_inputs(n))})
    jcfg = _tiny_noaug(jax_get_config)
    jstate = jtrain.create_state(jcfg, JaxPoseModel(jcfg), jax.random.PRNGKey(0))
    torch.save(params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)), data / "init.pt")
    # The bf16 steps' weights: the uniform spatial kernels perturbed, as the
    # served-slice tests do.  Uniform kernels wider than the coarse grid give
    # every pixel the same response, so the biases' gradient is a constant
    # over the map, which the spatial softmax cancels to rounding noise.
    bf16_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    sm = bf16_params["spatial_model"]
    sm["raw_kernels"] = sm["raw_kernels"] + 0.5 * np.random.RandomState(0).randn(
        *sm["raw_kernels"].shape).astype(np.float32)
    torch.save(params_from_flax(bf16_params), data / "init_bf16.pt")
    train_ds, _ = jpipe.make_dataset(jcfg.data)
    batch = {k: np.asarray(v) for k, v in train_ds.get_batch(jnp.arange(8, dtype=jnp.int32)).items()}
    np.savez(data / "batch.npz", **batch)
    jaug = jcfg.replace(augment=dataclasses.replace(jcfg.augment, enabled=True,
                                                    crop_frac_range=(0.8, 1.0)))
    draw = ja.random_augment_params(jax.random.PRNGKey(3), 8, jaug.augment, jaug.data.image_hw)
    np.savez(data / "draw.npz", **{f: np.asarray(v) for f, v in zip(draw._fields, draw)})
    jcfg_e, _, arrays, jmodel, variables, model = _setup(10, tta=False)
    np.savez(data / "eval.npz", **arrays)
    torch.save(model.state_dict(), data / "eval_weights.pt")
    write_initial_checkpoint(get_config("tiny"), str(data / "ckpt"), model.state_dict())

    script = data / "child.py"
    script.write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         str(script), str(data)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    ranks = [torch.load(data / f"rank{r}.pt", weights_only=False) for r in range(4)]

    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jtrain._make_step_body(jcfg, "joint"))
    ref = {}
    ref["step"] = step(jstate, batch_j)
    monkey = jtrain.random_augment_params
    jtrain.random_augment_params = lambda *a: draw
    try:
        ref["step_aug"] = jax.jit(jtrain._make_step_body(jaug, "joint"))(jstate, batch_j)
    finally:
        jtrain.random_augment_params = monkey
    # flagship's own MRF path in bf16: the port's one-device step and the
    # reference's loss and gradients at the same config and weights.
    tcfg_b = _bf16_xla(_tiny_noaug(get_config))
    state = create_state(tcfg_b, torch.Generator().manual_seed(0), device="cpu")
    state.model.load_state_dict(torch.load(data / "init_bf16.pt", weights_only=True))
    state, metrics = make_train_step(tcfg_b, "joint")(
        state, {k: torch.tensor(v) for k, v in batch.items()})
    ref["bf16_step"] = ({k: float(v) for k, v in metrics.items()},
                        {k: v.detach().numpy() for k, v in state.model.named_parameters()},
                        {k: v.grad.numpy() for k, v in state.model.named_parameters()})
    ref["bf16_reference"] = _reference_loss_and_grads(_bf16_xla(jcfg), bf16_params, batch_j)
    ref["bf16_reference_fp32"] = _reference_loss_and_grads(
        _bf16_xla(jcfg).replace(compute_dtype="float32"), bf16_params, batch_j)
    ref["eval"] = (jev.evaluate(variables, jpipe.from_host_arrays(arrays), jcfg_e, jmodel.apply),
                   _visible_counts(arrays, 10))
    with open(data / "eval_main.json") as f:
        ranks[0]["eval_main"] = json.load(f)
    one = data / "eval_one.json"
    tev.main(["--config", "tiny", "--checkpoint", str(data / "ckpt"), "--step", "0", "--device",
              "cpu", "--json-out", str(one)])
    with open(one) as f:
        ref["eval_main"] = json.load(f)
    return ranks, ref


def test_make_mesh_shapes_and_errors(world):
    ranks, _ = world
    assert tmesh.mesh_shape(MeshConfig(data=-1, model=2), 4) == (2, 2)
    assert tmesh.mesh_shape(MeshConfig(data=8, model=1), 8) == (8, 1)
    assert tmesh.mesh_shape(MeshConfig(data=0, model=1), 1) == (1, 1)
    for cfg, world_size in ((MeshConfig(data=3, model=2), 8), (MeshConfig(data=2), 1),
                            (MeshConfig(data=-1, model=3), 4)):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            tmesh.mesh_shape(cfg, world_size)
    for r, got in enumerate(ranks):
        # Data-major, as the reference's reshape(data, model).
        assert got["mesh", "2x2"] == ({"data": 2, "model": 2}, {"data": r // 2, "model": r % 2})
        assert got["mesh", "4x1"] == ({"data": 4, "model": 1}, {"data": r, "model": 0})
        assert got["mesh", "1x4"] == ({"data": 1, "model": 4}, {"data": 0, "model": r})
        for d, m in ((3, 2), (1, 1), (-1, 3)):
            assert "does not cover the world of 4" in got["refused", d, m]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_pad_source_axis_matches_reference(n):
    p, k, b, _ = _tp_inputs(2)
    want = jtp.pad_source_axis(jnp.asarray(p), jnp.asarray(k), jnp.asarray(b), n)
    got = ttp.pad_source_axis(torch.from_numpy(p), torch.from_numpy(k), torch.from_numpy(b), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[-1] % n == 0


@pytest.mark.parametrize("n", [2, 4])
def test_pad_source_axis_in_bf16_matches_reference(n):
    """flagship's sharded pass pads bf16 unaries and kernels (its biases stay
    fp32): the same zeros and unit biases as the reference, in the same types."""
    p, k, b, _ = _tp_inputs(2)
    want = jtp.pad_source_axis(jnp.asarray(p, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                               jnp.asarray(b), n)
    got = ttp.pad_source_axis(torch.from_numpy(p).bfloat16(), torch.from_numpy(k).bfloat16(),
                              torch.from_numpy(b), n)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_param_shardings_match_reference():
    jcfg = _tiny_noaug(jax_get_config)
    params = JaxPoseModel(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 64, 3)))["params"]
    want = jmesh.param_shardings(params, jmesh.make_mesh(JaxMeshConfig(data=4, model=2)))
    state_dict = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    got = tmesh.param_shardings(state_dict, tmesh.Mesh(4, 2))
    hwio_to_oihw = {3: 0, 2: 1}
    flat = {jax.tree_util.keystr(path): s.spec
            for path, s in jax.tree_util.tree_leaves_with_path(want)}
    for key, spec in flat.items():
        parts = [k.strip("'[]") for k in key.split("][")]
        leaf = parts[-1]
        name = ".".join(parts[:-1] + ["weight" if leaf == "kernel" else leaf])
        dims = [i for i, axis in enumerate(spec) if axis == "model"]
        if not dims:
            assert got[name] is None, name
        elif leaf == "kernel":
            assert got[name] == ("model", hwio_to_oihw[dims[0]]), name
        else:
            assert got[name] == ("model", dims[0]), name
    assert set(flat) and len(flat) == len(got)
    assert got["detector.head_wide.weight"] == ("model", 0)
    assert got["detector.head_1x1_0.weight"] == ("model", 1)
    assert all(v is None for v in tmesh.param_shardings(state_dict, tmesh.Mesh(8, 1)).values())


def _reference_tp(n):
    p, k, b, r = (jnp.asarray(x) for x in _tp_inputs(n))
    out = jax_pass(p, k, b, precision=HI)
    grads = jax.grad(lambda *a: jnp.sum(jax_pass(*a, precision=HI) * r),
                     argnums=(0, 1, 2))(p, k, b)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
def test_tp_pass_matches_unsharded_reference(world, n):
    ranks, _ = world
    want = _reference_tp(n)
    for got in ranks:
        *values, shapes = got["tp", n]
        np.testing.assert_allclose(values[0], want[0], atol=TP_ATOL)
        for g, w, what in zip(values[1:], want[1:], ("dp", "dkernels", "dbiases")):
            assert np.abs(w).max() > 1.0, what  # the cotangent reaches every input
            assert np.abs(g - w).max() / np.abs(w).max() <= TP_GRAD_RTOL, what
    # The pass ran on slices: Kp = ceil(9 / n) * n sources split n ways.
    (hw, win), kv = TP_GEOMETRY[n], -(-9 // n)
    assert ranks[0]["tp", n][-1] == ((4, *hw, kv), (*win, kv, 9), (kv, 9))


def test_tp_gradients_are_not_scaled_by_the_model_size(world):
    """Each model rank holds the whole loss: an all-reduce that also sums
    in the backward would scale every gradient by n_model."""
    ranks, _ = world
    for n in (2, 4):
        want = _reference_tp(n)
        for g, w in zip(ranks[0]["tp", n][1:4], want[1:]):
            ratio = np.linalg.norm(g) / np.linalg.norm(w)
            assert abs(ratio - 1.0) < 1e-4, (n, ratio)


def _assert_step_matches(got, ref, what):
    metrics, params, _ = got
    jstate, jmet = ref
    assert metrics["loss"] == pytest.approx(float(jmet["loss"]), rel=LOSS_RTOL), what
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert set(params) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(params[name], w.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", ["dp", "dp_aug", "2x2", "2x2_spatial"])
def test_sharded_step_matches_single_device_reference(world, name):
    ranks, ref = world
    for got in ranks:
        _assert_step_matches(got["step", name], ref["step_aug" if name == "dp_aug" else "step"],
                             f"{name}, rank {got['rank']}")
    sliced = ranks[0]["step", name][2]
    tp = ["detector.head_1x1_0.weight", "detector.head_wide.bias", "detector.head_wide.weight",
          "spatial_model.raw_bias", "spatial_model.raw_kernels"]
    if name == "2x2":
        assert sliced == tp
    elif name == "2x2_spatial":
        # Each rank's trunk sees its rows only: every trunk parameter's
        # gradient is summed over 'model' too.
        trunk = [f"detector.trunk.conv{i}.{w}" for i in range(2) for w in ("bias", "weight")]
        assert sliced == sorted(tp + trunk)
    else:
        assert sliced == []


@pytest.mark.parametrize("name", ["2x2", "2x2_spatial", "4x1"])
def test_evaluate_over_a_mesh_matches_reference(world, name):
    ranks, ref = world
    want, visible = ref["eval"]
    for got in ranks:
        assert got["eval", name] == ranks[0]["eval", name]  # every rank the same PDJ
    got = ranks[0]["eval", name]
    assert got["num_examples"] == 10.0
    _assert_evals_agree(got, want, visible)


def test_evaluate_main_over_the_launcher_matches_one_process(world):
    ranks, ref = world
    got, want = ranks[0]["eval_main"], ref["eval_main"]
    assert got["num_examples"] == want["num_examples"] == 8.0
    np.testing.assert_allclose(got["pdj_curves"], want["pdj_curves"], atol=1e-6)


def test_spatial_parallelism_is_not_ported():
    """Spatial parallelism is ported: ``spatial=True`` splits the trunk's
    rows where the 'model' axis is larger than 1, and every trunk
    parameter is then summed over 'model'; on a model axis of 1 it engages
    nothing, like tensor parallelism."""
    model = PoseModel(get_config("tiny"), mesh=tmesh.Mesh(2, 2), spatial=True)
    assert model.spatial and model.detector.spatial
    trunk = {f"detector.{n}" for n, _ in model.detector.named_parameters() if n.startswith("trunk")}
    assert len(trunk) == 4 and trunk <= model.model_sliced_parameters()
    # The model axis of 1 engages no parallelism: the one-device model.
    model = PoseModel(get_config("tiny"), mesh=tmesh.Mesh(4, 1), spatial=True)
    assert not model.spatial and not model.detector.head_tp and not model.spatial_model.tp
    assert model.model_sliced_parameters() == set()


@pytest.mark.parametrize("n_model", [2, 4])
def test_the_trainer_slices_what_param_shardings_names(n_model):
    mesh = tmesh.Mesh(8 // n_model, n_model)
    model = PoseModel(get_config("tiny"), mesh=mesh)
    rule = {name for name, spec in tmesh.param_shardings(model, mesh).items() if spec}
    assert rule == {"detector.head_wide.weight", "detector.head_wide.bias",
                    "detector.head_1x1_0.weight"}
    assert model.detector.head_tp and model.spatial_model.tp
    # The MRF's two parameters are sliced at the activations (mrf_tp.py).
    assert model.model_sliced_parameters() == rule | {"spatial_model.raw_kernels",
                                                      "spatial_model.raw_bias"}


@pytest.mark.parametrize("name", ["dp", "2x2", "2x2_spatial"])
def test_kstep_dispatch_over_a_mesh_equals_single_steps(world, name):
    ranks, _ = world
    for got in ranks:
        (params, moments, metrics, step, gen), (w_params, w_moments, w_metrics, w_step, w_gen) = (
            got["kstep", name])
        what = f"{name}, rank {got['rank']}"
        assert step == w_step == 5, what
        assert params.keys() == w_params.keys()
        for n, w in w_params.items():
            assert torch.equal(params[n], w), f"{what}: {n}"
        assert len(moments) == len(w_moments) > 0
        assert all(torch.equal(a, b) for a, b in zip(moments, w_moments)), what
        assert metrics.keys() == w_metrics.keys() and "mrf_loss" in metrics
        assert all(torch.equal(metrics[k], w_metrics[k]) for k in w_metrics), what
        assert torch.equal(gen, w_gen), what


@pytest.mark.parametrize("name", ["dp", "2x2", "2x2_spatial"])
def test_a_reload_on_one_rank_recaptures_on_every_rank(world, name):
    """The mesh's rank 1 reloads its optimizer state before the fourth
    dispatch: every rank finds the graphs stale there and warms the stage
    again, then every rank captures at the fifth."""
    ranks, _ = world
    want = [("stale",), ("kept", "capture", "replay"), ("kept", "replay"), ("stale",),
            ("kept", "capture", "replay")]
    for got in ranks:
        assert got["recapture", name] == want, f"{name}, rank {got['rank']}"


@pytest.mark.parametrize("name", ["dp", "2x2", "2x2_spatial"])
def test_a_capture_that_fails_on_one_rank_raises_on_every_rank(world, name):
    """The mesh's rank 1 fails its capture at the second dispatch: it
    raises its own error, and every other rank raises too, rather than
    replaying collectives that rank 1 never joins."""
    ranks, _ = world
    for got in ranks:
        mesh_rank, raised = got["capture_failure", name]
        want = "stub capture failed" if mesh_rank == 1 else "failed on another rank of the mesh"
        assert raised is not None and want in raised, f"{name}, rank {got['rank']}: {raised}"


def _max_rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def test_one_device_bf16_step_matches_reference(world):
    """The port's one-device bf16 step on flagship's own MRF path against
    the reference at the same config and weights: the loss and the MRF's
    gradients against its bf16 step, the detector's gradients against its
    fp32 step (``BF16_DETECTOR_GRAD_RTOL``'s comment)."""
    _, ref = world
    metrics, _, grads = ref["bf16_step"]
    loss, want = ref["bf16_reference"]
    _, exact = ref["bf16_reference_fp32"]
    assert set(grads) == set(want) == set(exact)
    assert metrics["loss"] == pytest.approx(loss, rel=BF16_LOSS_RTOL)
    mrf = {n: _max_rel(grads[n], w) for n, w in want.items() if n.startswith("spatial_model")}
    det = {n: _max_rel(grads[n], w) for n, w in exact.items() if n not in mrf}
    own = max(_max_rel(want[n], w) for n, w in exact.items() if n not in mrf)
    print(f"bf16 one-device step against the reference: loss {metrics['loss']:.7f} against "
          f"{loss:.7f}; MRF gradients {max(mrf.values()):.3e} of the largest (bar "
          f"{BF16_GRAD_RTOL:g}); detector gradients {max(det.values()):.3e} from the reference's "
          f"fp32 step (bar {BF16_DETECTOR_GRAD_RTOL:g}), where the reference's own bf16 step is "
          f"{own:.3e} from it")
    assert len(mrf) == 2 and max(mrf.values()) <= BF16_GRAD_RTOL, mrf
    assert max(det.values()) <= BF16_DETECTOR_GRAD_RTOL, det


@pytest.mark.parametrize("name", ["dp", "2x2", "2x2_spatial"])
def test_sharded_bf16_step_matches_one_device(world, name):
    """flagship's own MRF path in bf16, sharded, against the port's
    one-device step: the loss, every gradient, and the parameters after
    Adam's first update, held where the update's sign is determined
    (``BF16_FLIP_SHARE``'s comment)."""
    ranks, ref = world
    w_metrics, w_params, w_grads = ref["bf16_step"]
    train = get_config("tiny").train
    flip = 2 * train.learning_rate * max(1.0, train.mrf_lr_mult) + PARAM_ATOL
    n_params = sum(w.size for w in w_params.values())
    for got in ranks:
        metrics, params, grads, _ = got["bf16_step", name]
        what = f"{name}, rank {got['rank']}"
        assert metrics["loss"] == pytest.approx(w_metrics["loss"], rel=BF16_LOSS_RTOL), what
        worst = max((_max_rel(grads[n], w), n) for n, w in w_grads.items())
        assert worst[0] <= BF16_GRAD_RTOL, (what, worst)
        exempt = beyond = 0
        for n, w in w_params.items():
            g = np.abs(w_grads[n])
            held = g >= BF16_GRAD_RTOL * g.max()
            diff = np.abs(params[n].astype(np.float64) - w)
            share = diff / (PARAM_ATOL + PARAM_RTOL * np.abs(w))
            assert (share[held] <= 1).all(), f"{what}: {n}"
            assert (diff[~held] <= flip).all(), f"{what}: {n} moved beyond one flipped update"
            exempt += int((~held).sum())
            beyond += int((share[~held] > 1).sum())
        print(f"bf16 step {what}: loss rel {abs(metrics['loss'] / w_metrics['loss'] - 1):.3e}, "
              f"gradients {worst[0]:.3e} (worst {worst[1]}); {exempt} of {n_params} parameters "
              f"exempt, {beyond} of them beyond the tolerance")
        assert beyond <= BF16_FLIP_SHARE * n_params, (what, beyond)


@pytest.mark.parametrize("name,sources", [("dp", 9), ("2x2", 5), ("2x2_spatial", 5)])
def test_sharded_bf16_step_runs_the_grouped_conv_function(world, name, sources):
    """The bf16 step's pairwise conv is ``grouped_conv_f32`` once a forward,
    on every source at data 2 and on a rank's 5 of the padded 10 at model 2."""
    ranks, _ = world
    for got in ranks:
        assert got["bf16_step", name][3] == [sources], f"{name}, rank {got['rank']}"
