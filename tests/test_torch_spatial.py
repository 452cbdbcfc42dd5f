"""Spatial parallelism (jointpose_torch.parallel.spatial, the detector's
row-sharded trunk) and the one-process inference meshes against the JAX
reference on the CPU, in fp32 on ``tiny`` (batch 8, no augmentation, as
``tests/test_parallel.py``'s ``tiny_noaug``):

- the spatial forward over the device mesh ``["cpu"] * 8`` (data 4 x model
  2) against the reference's ``PoseModel(mesh=make_mesh(data=4, model=2),
  spatial=True)`` on its 8 fake devices, for both trunk pool modes, at
  ``tests/test_parallel.py:234-243``'s tolerance;
- the halo geometry against an unsharded conv (kernel 3 and 5, stride 1
  and 2, 2 and 4 shards), over devices and over ranks: the process
  exchange's autograd functions run on threads standing in for the ranks
  of a 'model' axis, forward and backward against the unsharded conv;
- unaligned rows raise as the reference does (``:246-253``);
- ``build_predictor(mesh=)`` at data 8 and at 2x2 spatial against the
  reference's ``build_predictor(mesh=)`` (``:283ff``), and ``PoseService``
  over a mesh;
- the mesh flags of ``serve.main`` and ``evaluate.main`` and their
  refusals (``predict.main``'s are in tests/test_torch_predict_main.py,
  ``evaluate.main`` over the launcher in tests/test_torch_parallel.py).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import MeshConfig as JaxMeshConfig
from jointpose.configs import get_config as jax_get_config
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.parallel.mesh import make_mesh as jax_make_mesh
from jointpose.predict import build_predictor as jax_build_predictor
from jointpose_torch import evaluate as tev
from jointpose_torch import get_config, serve
from jointpose_torch.convert import params_from_flax, write_initial_checkpoint
from jointpose_torch.models.detector import Conv
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.parallel import mesh as tmesh
from jointpose_torch.parallel.mesh import DeviceMesh, make_device_mesh
from jointpose_torch.parallel.spatial import (
    DeviceRows, gather_rows, halo_exchange, halo_rows, row_shard,
)
from jointpose_torch.predict import DeviceMeshModel, build_predictor

from test_torch_predict import COORD_ATOL, MRF_RTOL, _rel

# tests/test_parallel.py:234-243: the spatial forward against one device.
SP_RTOL, SP_ATOL = 2e-4, 1e-5


def _tiny_noaug(get, pool_mode="max"):
    c = get("tiny")
    return c.replace(augment=dataclasses.replace(c.augment, enabled=False),
                     train=dataclasses.replace(c.train, batch_size=8),
                     detector=dataclasses.replace(c.detector, pool_mode=pool_mode))


def _weights(jcfg, seed=1):
    """The reference's initial variables with perturbed MRF kernels, and the
    same as the port's ``state_dict``."""
    h, w = jcfg.data.image_hw
    variables = JaxPoseModel(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sm = variables["params"]["spatial_model"]
    sm["raw_kernels"] = sm["raw_kernels"] + 0.5 * np.random.RandomState(seed).randn(
        *sm["raw_kernels"].shape).astype(np.float32)
    return variables, params_from_flax(variables)


def _images(cfg, n=8, seed=1):
    h, w = cfg.data.image_hw
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("pool_mode", ["max", "stride"])
def test_spatial_forward_matches_reference(pool_mode):
    jcfg, tcfg = _tiny_noaug(jax_get_config, pool_mode), _tiny_noaug(get_config, pool_mode)
    variables, state = _weights(jcfg)
    images = _images(tcfg)
    mesh = jax_make_mesh(JaxMeshConfig(data=4, model=2))
    want = jax.jit(JaxPoseModel(jcfg, mesh=mesh, spatial=True).apply)(variables, images)
    model = DeviceMeshModel(tcfg, state, DeviceMesh(["cpu"] * 8, 4, 2), spatial=True)
    assert model.spatial
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for key in ("detector_logits", "mrf_log_heatmaps"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=SP_RTOL,
                                   atol=SP_ATOL, err_msg=key)


def test_halo_rows_follow_the_global_same_padding():
    # flagship's stride-2 5x5 convs on even rows: 1 above, 2 below.
    assert halo_rows(240, 5, 2) == halo_rows(60, 5, 2) == (1, 2)
    for k in (1, 3, 5, 9):
        assert halo_rows(48, k, 1) == ((k - 1) // 2, (k - 1) // 2)
    assert row_shard(48, 4, 1) == slice(12, 24)
    with pytest.raises(ValueError, match="divide"):
        row_shard(48, 5, 0)


def _conv(k, s, seed=0):
    gen = torch.Generator().manual_seed(seed)
    conv = Conv(3, 4, k, s)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / k)
        conv.bias.copy_(torch.randn(4, generator=gen))
    x = torch.randn(2, 3, 16, 12, generator=gen)
    cot = torch.randn(2, 4, 16 // s, 12 // s, generator=gen)
    return conv, x, cot


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k,s", [(3, 1), (5, 1), (3, 2), (5, 2)])
def test_halos_over_devices_match_an_unsharded_conv(k, s, n):
    conv, x, _ = _conv(k, s)
    rows = DeviceRows(["cpu"] * n)
    with torch.no_grad():
        want = conv(x)
        shards = rows.halo(rows.split(x), *halo_rows(16, k, s))
        got = rows.gather([conv(sh, rows_padded=True) for sh in shards])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


class _ThreadMesh:
    """Rank ``m`` of a 'model' axis of ``n`` whose ranks are threads: its
    all-reduce sums every thread's tensor (a barrier on each side)."""

    def __init__(self, n, m, shared):
        self.shape, self.coords = {"data": 1, "model": n}, {"data": 0, "model": m}
        self.shared = shared

    def has_group(self, axis):
        return True

    def all_reduce(self, x, axis=None, op=None):
        slots, barrier = self.shared
        slots[self.coords["model"]] = x.clone()
        barrier.wait()
        total = sum(slots)
        barrier.wait()
        return x.copy_(total)


def _on_threads(n, fn):
    """fn(mesh) on n threads, one per rank; their results in rank order."""
    shared = ([None] * n, threading.Barrier(n, timeout=60))
    out, errors = [None] * n, []

    def run(m):
        try:
            out[m] = fn(_ThreadMesh(n, m, shared))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            shared[1].abort()

    threads = [threading.Thread(target=run, args=(m,)) for m in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_halo_exchange_and_gather_over_ranks_match_an_unsharded_conv(k, s, n):
    """Forward and backward: each halo's gradient is added into the
    neighbour's edge rows, the gather's backward sums nothing (every rank
    holds the whole loss), and the weight's gradients summed over the
    ranks are the unsharded conv's."""
    conv, x, cot = _conv(k, s)
    x = x.requires_grad_()
    want = conv(x)
    (want * cot).sum().backward()
    want_dw = conv.weight.grad.clone()
    weights = (conv.weight.detach(), conv.bias.detach())

    def rank_fn(mesh):
        mine = Conv(3, 4, k, s)
        with torch.no_grad():
            mine.weight.copy_(weights[0])
            mine.bias.copy_(weights[1])
        xm = x.detach()[:, :, row_shard(16, n, mesh.coords["model"])].clone().requires_grad_()
        y = gather_rows(mine(halo_exchange(xm, mesh, *halo_rows(16, k, s)), rows_padded=True),
                        mesh)
        (y * cot).sum().backward()
        return y.detach(), xm.grad, mine.weight.grad

    results = _on_threads(n, rank_fn)
    for y, _, _ in results:
        np.testing.assert_allclose(y.numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)
    dx = torch.cat([r[1] for r in results], dim=2)
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-6)
    dw = sum(r[2] for r in results)
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), rtol=1e-5, atol=1e-5)


def test_halos_deeper_than_a_shard_raise():
    x = torch.zeros(1, 2, 1, 4)
    with pytest.raises(ValueError, match="deeper"):
        DeviceRows(["cpu"] * 2).halo([x, x], 2, 2)
    mesh = _ThreadMesh(2, 0, None)
    with pytest.raises(ValueError, match="deeper"):
        halo_exchange(x, mesh, 1, 2)


def test_spatial_rejects_unaligned_rows():
    # 48 rows at stride-8 alignment split over 2 but not over 4 shards.
    cfg = _tiny_noaug(get_config)
    _, state = _weights(_tiny_noaug(jax_get_config))
    images = torch.zeros(2, *cfg.data.image_hw, 3)
    with pytest.raises(ValueError, match="spatial sharding"):
        DeviceMeshModel(cfg, state, DeviceMesh(["cpu"] * 8, 2, 4), spatial=True)(images)
    # Over processes the check comes at the forward, before any exchange.
    model = PoseModel(cfg, mesh=tmesh.Mesh(2, 4), spatial=True)
    model.load_state_dict(state)
    with pytest.raises(ValueError, match="spatial sharding"):
        model(images)
    with pytest.raises(ValueError, match="needs a mesh"):
        model.detector.__class__(cfg.detector, 9, spatial=True)


@pytest.mark.parametrize("data,model", [(8, 1), (2, 2)])
def test_predictor_over_a_device_mesh_matches_reference(data, model):
    jcfg, tcfg = _tiny_noaug(jax_get_config), _tiny_noaug(get_config)
    variables, state = _weights(jcfg, seed=0)
    images = _images(tcfg, seed=0)
    jmesh = jax_make_mesh(JaxMeshConfig(data=data, model=model))
    coords_j, probs_j = jax_build_predictor(jcfg, variables, mesh=jmesh, spatial=model > 1)(
        jnp.asarray(images))
    predict = build_predictor(tcfg, state, mesh=DeviceMesh(["cpu"] * (data * model), data, model),
                              spatial=model > 1)
    coords, probs = predict(torch.from_numpy(images))
    assert _rel(probs, probs_j) <= MRF_RTOL
    np.testing.assert_allclose(coords.numpy(), np.asarray(coords_j), rtol=0, atol=COORD_ATOL)
    with pytest.raises(ValueError, match="data axis"):
        predict(torch.from_numpy(images[:3]))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = _tiny_noaug(get_config)
    _, state = _weights(_tiny_noaug(jax_get_config))
    ckpt = str(tmp_path_factory.mktemp("spatial_ck"))
    write_initial_checkpoint(cfg, ckpt, state)
    return cfg, state, ckpt


def test_pose_service_over_a_mesh(checkpoint):
    cfg, state, ckpt = checkpoint
    mesh = DeviceMesh(["cpu"] * 4, 2, 2)
    with pytest.raises(ValueError, match="do not divide the mesh data axis"):
        serve.PoseService(cfg, ckpt, batch_size=4, best=False, mesh=mesh, batch_buckets=[1])
    svc = serve.PoseService(cfg, ckpt, batch_size=4, best=False, mesh=mesh, batch_buckets=[2])
    try:
        images = (_images(cfg, n=3, seed=5) * 255).astype(np.uint8)
        got = np.array([list(p["joints"].values()) for p in svc.predict(images)], np.float32)
    finally:
        svc.close()
    padded = torch.from_numpy(np.concatenate([images, np.zeros_like(images[:1])]))
    want = build_predictor(cfg, state, device="cpu")(padded)[0][:3]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=COORD_ATOL)


def test_serve_main_builds_the_device_mesh(checkpoint, monkeypatch):
    _, _, ckpt = checkpoint
    seen = {}

    class Stop(Exception):
        pass

    def fake_service(config, checkpoint_dir, batch_size, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(serve, "PoseService", fake_service)
    with pytest.raises(Stop):
        serve.main(["--config", "tiny", "--checkpoint", ckpt, "--device", "cpu", "--batch-size",
                    "4", "--mesh-data", "2", "--mesh-model", "2"])
    assert seen["mesh"].shape == {"data": 2, "model": 2}
    assert [str(d) for d in seen["mesh"].devices] == ["cpu"] * 4
    with pytest.raises(Stop):
        serve.main(["--config", "tiny", "--checkpoint", ckpt, "--device", "cpu"])
    assert seen["mesh"] is None
    with pytest.raises(SystemExit):  # the data axis must divide the batch
        serve.main(["--config", "tiny", "--checkpoint", ckpt, "--device", "cpu", "--batch-size",
                    "4", "--mesh-data", "3"])
    assert make_device_mesh(2, 1, "cpu").row(1) == [torch.device("cpu")]


def test_evaluate_main_mesh_refusals(checkpoint, monkeypatch):
    _, _, ckpt = checkpoint
    common = ["--config", "tiny", "--checkpoint", ckpt, "--step", "0", "--device", "cpu"]
    # Without a launcher one process holds a mesh of one.
    with pytest.raises(ValueError, match="torch.distributed.run"):
        tev.main([*common, "--mesh-model", "2"])
    # Under a launcher the int8 detector is exclusive with a mesh.
    monkeypatch.setattr(tmesh, "make_mesh", lambda cfg: tmesh.Mesh(2, 2))
    with pytest.raises(SystemExit, match="exclusive"):
        tev.main([*common, "--mesh-data", "2", "--mesh-model", "2", "--quantize", "4"])
