"""The port's HTTP inference server (jointpose_torch.serve) on the CPU, on
`tiny` in fp32 at the serving default, MRF precision 'default'.

One seeded flax state is written by the reference's Checkpointer; the
same parameters, converted by params_from_flax, are written for the port
by write_initial_checkpoint.  Both packages' PoseService answer the same
requests, and the port's coalescing, bucket choice, load shedding, HTTP
handler and SIGTERM drain are checked as the reference's tests check
the reference's (tests/test_serve.py)."""

import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.checkpoint import Checkpointer as JaxCheckpointer
from jointpose.configs import get_config as jax_get_config
from jointpose.configs import with_mrf_precision as jax_with_mrf_precision
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.serve import PoseService as JaxPoseService
from jointpose.train import create_state as jax_create_state
from jointpose_torch import serve, skeleton
from jointpose_torch.configs import get_config, with_mrf_precision
from jointpose_torch.convert import params_from_flax, write_initial_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Decoded coordinates in image pixels (tests/test_torch_predict.py).
COORD_ATOL = 1e-3


def _tiny(get, with_precision):
    cfg = get("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
    return with_precision(cfg, "default")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    jcfg, tcfg = _tiny(jax_get_config, jax_with_mrf_precision), _tiny(get_config, with_mrf_precision)
    state = jax_create_state(jcfg, JaxPoseModel(jcfg), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    params = {**params, "spatial_model": dict(params["spatial_model"])}
    # Perturb the uniform spatial kernels so each target joint differs.
    raw = params["spatial_model"]["raw_kernels"]
    params["spatial_model"]["raw_kernels"] = raw + 0.5 * np.random.RandomState(0).randn(
        *raw.shape).astype(np.float32)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jdir, tdir = str(tmp_path_factory.mktemp("jax_ck")), str(tmp_path_factory.mktemp("torch_ck"))
    ckpt = JaxCheckpointer(jdir, keep=1)
    ckpt.save(0, state)
    ckpt.close()
    write_initial_checkpoint(tcfg, tdir, params_from_flax(params))
    return jcfg, tcfg, jdir, tdir


@pytest.fixture(scope="module")
def service(checkpoints):
    _, tcfg, _, tdir = checkpoints
    svc = serve.PoseService(tcfg, tdir, batch_size=2, best=False, device="cpu")
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def live_server(checkpoints, service):
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield checkpoints[1], server.server_address[1]
    server.shutdown()
    server.server_close()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _post(port, path, data, ctype="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _npy(images):
    buf = io.BytesIO()
    np.save(buf, images)
    return buf.getvalue()


def _coords(preds):
    return np.array([[p["joints"][name] for name in p["joints"]] for p in preds])


def _images(cfg, n, dtype, seed):
    rs = np.random.RandomState(seed)
    h, w = cfg.data.image_hw
    if dtype == "uint8":
        return rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    return rs.rand(n, h, w, 3).astype(np.float32)


def test_services_answer_like_the_reference(checkpoints, service):
    jcfg, tcfg, jdir, _ = checkpoints
    ref = JaxPoseService(jcfg, jdir, batch_size=2, best=False)
    try:
        assert ref.step == service.step == 0
        for n in (1, 2, 3):
            for dtype in ("uint8", "float32"):
                images = _images(tcfg, n, dtype, seed=n)
                got, want = service.predict(images), ref.predict(images)
                assert len(got) == len(want) == n
                assert [list(p["joints"]) for p in got] == [list(p["joints"]) for p in want]
                np.testing.assert_allclose(_coords(got), _coords(want), rtol=0, atol=COORD_ATOL)
    finally:
        ref.close()


def test_quantized_services_answer_like_the_reference(checkpoints, tmp_path):
    """Both packages' PoseService on one int8 artifact (the reference's
    quantize_detector on its restored parameters), warmed and answering
    as the float services do."""
    from jointpose.ops.quant import quantize_detector, save_quantized
    from jointpose.predict import restore_params as jax_restore_params
    from jointpose_torch.ops.quant import build_quantized_predictor, load_quantized
    from jointpose_torch.predict import restore_params

    jcfg, tcfg, jdir, tdir = checkpoints
    params, _ = jax_restore_params(jcfg, jdir, 0)
    artifact = str(tmp_path / "int8.npz")
    save_quantized(artifact, quantize_detector(jcfg, params, jnp.asarray(
        _images(tcfg, 4, "float32", seed=9))))
    ref = JaxPoseService(jcfg, jdir, batch_size=2, best=False, quantize_artifact=artifact)
    svc = serve.PoseService(tcfg, tdir, batch_size=2, best=False, quantize_artifact=artifact,
                            batch_buckets=[1], device="cpu")
    try:
        for n, dtype in ((1, "uint8"), (3, "float32")):
            images = _images(tcfg, n, dtype, seed=10 + n)
            got, want = svc.predict(images), ref.predict(images)
            np.testing.assert_allclose(_coords(got), _coords(want), rtol=0, atol=COORD_ATOL)
        # The service's answers are the quantized predictor's.
        images = _images(tcfg, 2, "uint8", seed=20)
        state, _ = restore_params(tcfg, tdir, 0)
        direct = build_quantized_predictor(tcfg, state, qparams=load_quantized(artifact),
                                           device="cpu")(torch.from_numpy(images))[0]
        np.testing.assert_array_equal(_coords(svc.predict(images)), direct.numpy())
    finally:
        ref.close()
        svc.close()
    # Calibrating in the service: the train split's first images.
    calibrated = serve.PoseService(tcfg, tdir, batch_size=2, best=False, quantize_calib=4,
                                   device="cpu")
    try:
        assert len(calibrated.predict(_images(tcfg, 1, "uint8", seed=21))) == 1
    finally:
        calibrated.close()
    with pytest.raises(ValueError, match="exclusive"):
        serve.PoseService(tcfg, tdir, batch_size=2, best=False, mesh=object(),
                          quantize_artifact=artifact, device="cpu")


def test_main_passes_the_quantize_flags(checkpoints, monkeypatch):
    _, _, _, tdir = checkpoints
    seen = {}

    class Stop(Exception):
        pass

    def fake_service(config, checkpoint_dir, batch_size, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(serve, "PoseService", fake_service)
    for flags, want in ((["--quantize", "8"], (8, None)),
                        (["--quantize-artifact", "q.npz"], (0, "q.npz"))):
        with pytest.raises(Stop):
            serve.main(["--config", "tiny", "--checkpoint", tdir, "--device", "cpu", *flags])
        assert (seen["quantize_calib"], seen["quantize_artifact"]) == want


def test_micro_batcher_coalesces(checkpoints):
    _, tcfg, _, tdir = checkpoints
    svc = serve.PoseService(tcfg, tdir, batch_size=2, best=False, batch_wait_ms=500.0,
                            device="cpu")
    try:
        imgs = _images(tcfg, 8, "float32", seed=11)[:, None]
        want = [svc.predict(imgs[i]) for i in range(8)]
        base = svc.stats["dispatches"]
        results = [None] * 8

        def worker(i):
            results[i] = svc.predict(imgs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        used = svc.stats["dispatches"] - base
        assert used <= 5, f"8 one-image requests used {used} dispatches"
        assert svc.stats["coalesced_batches"] >= 1
        for got, ref in zip(results, want):
            np.testing.assert_allclose(_coords(got), _coords(ref), rtol=0, atol=COORD_ATOL)
    finally:
        svc.close()


def test_batch_buckets(checkpoints):
    _, tcfg, _, tdir = checkpoints
    svc = serve.PoseService(tcfg, tdir, batch_size=4, best=False, batch_wait_ms=0.0,
                            batch_buckets=[1, 2], device="cpu")
    try:
        seen = []
        real = svc._predict

        def spy(images):
            seen.append(tuple(images.shape))
            return real(images)

        svc._predict = spy
        svc.predict(_images(tcfg, 1, "float32", seed=13))
        svc.predict(_images(tcfg, 3, "float32", seed=14))
        with svc._stats_lock:
            fills = list(svc._fills)
        assert fills == [1.0, 3 / 4]  # 1 image -> bucket 1; 3 images -> the full batch of 4
        assert [s[0] for s in seen] == [1, 4]
    finally:
        svc.close()
    with pytest.raises(ValueError, match="batch_buckets"):
        serve.PoseService(tcfg, tdir, batch_size=4, best=False, batch_buckets=[8], device="cpu")


def test_overload_sheds_requests(checkpoints):
    _, tcfg, _, tdir = checkpoints
    svc = serve.PoseService(tcfg, tdir, batch_size=2, best=False, batch_wait_ms=0.0,
                            max_queue_images=4, device="cpu")
    real = svc._predict
    try:
        def slow_predict(x):
            time.sleep(0.25)  # a saturated device: drain far below arrival
            return real(x)

        svc._predict = slow_predict
        imgs = _images(tcfg, 16, "float32", seed=3)[:, None]
        outcomes = [None] * 16

        def worker(i):
            try:
                outcomes[i] = ("ok", svc.predict(imgs[i]))
            except serve.ServiceOverloaded as e:
                outcomes[i] = ("shed", e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        sheds = [o for o in outcomes if o[0] == "shed"]
        oks = [o for o in outcomes if o[0] == "ok"]
        assert len(sheds) >= 8 and len(oks) >= 1
        m = svc.metrics()
        assert m["shed_requests"] == len(sheds) and m["queue_depth_images"] == 0
        assert m["max_queue_images"] == 4
    finally:
        svc._predict = real
        svc.close()


def test_overload_http_503(checkpoints):
    _, tcfg, _, tdir = checkpoints
    svc = serve.PoseService(tcfg, tdir, batch_size=2, best=False, batch_wait_ms=0.0,
                            max_queue_images=2, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    real = svc._predict
    try:
        def slow_predict(x):
            time.sleep(0.3)
            return real(x)

        svc._predict = slow_predict
        body = _npy(_images(tcfg, 1, "float32", seed=5))
        replies = [None] * 10

        def worker(i):
            replies[i] = _post(port, "/predict", body, "application/x-npy")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        codes = [r[0] for r in replies]
        assert 503 in codes and 200 in codes, codes
        assert all(r[2]["Retry-After"] == "1" for r in replies if r[0] == 503)
        svc._predict = real
        code, health, _ = _get(port, "/healthz")
        assert code == 200 and health["batcher"]["shed_requests"] == codes.count(503)
        assert _post(port, "/predict", body, "application/x-npy")[0] == 200
    finally:
        svc._predict = real
        server.shutdown()
        server.server_close()
        svc.close()


def test_healthz(live_server):
    cfg, port = live_server
    _post(port, "/predict", _npy(_images(cfg, 1, "float32", seed=9)), "application/x-npy")
    status, body, _ = _get(port, "/healthz")
    assert status == 200 and body["status"] == "ok" and body["step"] == 0
    assert body["config"] == "tiny"
    m = body["batcher"]
    assert m["dispatches"] >= 1 and "coalesced_batches" in m
    assert m["request_latency_ms"]["max"] >= m["request_latency_ms"]["p95"] >= \
        m["request_latency_ms"]["p50"] > 0
    assert 0 < m["mean_batch_fill"] <= 1.0


def test_predict_json(live_server):
    cfg, port = live_server
    h, w = cfg.data.image_hw
    imgs = _images(cfg, 3, "float32", seed=0)
    status, body, _ = _post(port, "/predict", json.dumps({"images": imgs.tolist()}).encode())
    assert status == 200 and len(body["predictions"]) == 3 and body["step"] == 0
    joints = body["predictions"][0]["joints"]
    assert list(joints) == list(skeleton.JOINTS)
    x, y = joints["nose"]
    assert 0 <= x <= w and 0 <= y <= h


def test_predict_npy_keeps_uint8(live_server, service):
    cfg, port = live_server
    imgs = _images(cfg, 2, "uint8", seed=2)
    seen = []
    real = service._predict

    def spy(images):
        seen.append(images.dtype)
        return real(images)

    service._predict = spy
    try:
        status, body, _ = _post(port, "/predict", _npy(imgs), "application/x-npy")
    finally:
        service._predict = real
    assert status == 200 and len(body["predictions"]) == 2
    assert [str(d) for d in seen] == ["torch.uint8"]
    np.testing.assert_allclose(_coords(body["predictions"]), _coords(service.predict(imgs)),
                               rtol=0, atol=0)


def test_bad_requests(live_server):
    _, port = live_server
    bad = np.zeros((1, 8, 8, 3), np.float32)
    status, body, _ = _post(port, "/predict", json.dumps({"images": bad.tolist()}).encode())
    assert status == 400 and "expected images of shape" in body["error"]
    assert _post(port, "/predict", b"{not json")[0] == 400
    assert _post(port, "/predict", json.dumps({"pixels": []}).encode())[0] == 400
    assert _post(port, "/nope", b"{}")[0] == 404
    assert _get(port, "/nope")[0] == 404


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sigterm_graceful_shutdown(checkpoints):
    _, tcfg, _, tdir = checkpoints
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jointpose_torch.serve", "--config", "tiny", "--checkpoint", tdir,
         "--port", str(port), "--batch-size", "2", "--step", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
    )
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                if _get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        assert proc.poll() is None, proc.communicate()[0][-2000:]
        status, body, _ = _post(port, "/predict", _npy(_images(tcfg, 1, "uint8", seed=4)),
                                "application/x-npy")
        assert status == 200 and len(body["predictions"]) == 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-2000:]
        assert "shut down cleanly" in out, out[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
