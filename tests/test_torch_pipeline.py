"""The port's input pipeline (jointpose_torch.data.pipeline, data.flic)
against the JAX reference.  The index maths is numpy on both sides and must
be bit-equal for the same ``np.random.Generator``; the FLIC loader is held
against the reference's on a directory the test writes itself."""

import dataclasses
import os

import numpy as np
import pytest
import torch

scipy_io = pytest.importorskip("scipy.io")
PIL_Image = pytest.importorskip("PIL.Image")

from jointpose.configs import DataConfig as JaxDataConfig
from jointpose.data import flic as jflic
from jointpose.data import pipeline as jpipe
from jointpose_torch.configs import DataConfig
from jointpose_torch.data import flic as tflic
from jointpose_torch.data import pipeline as tpipe

SRC_W, SRC_H = 720, 480


def make_fake_flic(root, n_train=3, n_test=2, seed=0):
    """A miniature FLIC directory: MATLAB struct annotations and JPEG frames."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rs = np.random.RandomState(seed)
    dt = [("filepath", object), ("coords", object), ("istrain", object), ("istest", object)]
    arr = np.zeros((n_train + n_test,), dtype=dt)
    for i in range(n_train + n_test):
        coords = np.full((2, 29), np.nan)
        for name, col in tflic._FLIC_COLUMNS.items():
            if name not in ("leye", "reye"):
                coords[:, col - 1] = rs.uniform([60, 60], [SRC_W - 60, SRC_H - 60])
        if i == 0:  # no nose: the loader falls back to the eye average
            coords[:, tflic._FLIC_COLUMNS["nose"] - 1] = np.nan
            le = rs.uniform([200, 100], [300, 200])
            coords[:, tflic._FLIC_COLUMNS["leye"] - 1] = le
            coords[:, tflic._FLIC_COLUMNS["reye"] - 1] = le + [40.0, 0.0]
        if i == 1:  # a missing wrist: invisible
            coords[:, tflic._FLIC_COLUMNS["lwri"] - 1] = np.nan
        fname = f"frame{i:03d}.jpg"
        # Blocks of 20 px: the contrast survives the loader's downscaling (pixel
        # noise would average out to grey frames, whose gradients nearly cancel).
        img = np.kron(rs.rand(SRC_H // 20, SRC_W // 20, 3) * 255, np.ones((20, 20, 1))).astype(np.uint8)
        PIL_Image.fromarray(img).save(os.path.join(root, "images", fname))
        arr[i] = (fname, coords, float(i < n_train), float(i >= n_train))
    scipy_io.savemat(os.path.join(root, "examples.mat"), {"examples": arr})


class _Sized:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("n,batch", [(16, 4), (3987, 32), (10, 4), (3, 8), (8, 8)])
@pytest.mark.parametrize("seed", [None, 0, 5])
def test_epoch_order_is_bit_equal(n, batch, seed):
    rng = (lambda: None) if seed is None else (lambda: np.random.default_rng(seed))
    want = jpipe.epoch_order(n, batch, rng())
    got = tpipe.epoch_order(n, batch, rng())
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tpipe.epoch_steps(_Sized(n), batch) == jpipe.epoch_steps(_Sized(n), batch)


@pytest.mark.parametrize("n,batch", [(16, 4), (10, 4), (3, 8), (1016, 256)])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batch_iterator_is_bit_equal(n, batch, drop_remainder):
    want = list(jpipe.batch_iterator(_Sized(n), batch, np.random.default_rng(3), drop_remainder))
    got = list(tpipe.batch_iterator(_Sized(n), batch, np.random.default_rng(3), drop_remainder))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_flic_loader_matches_reference(tmp_path):
    make_fake_flic(str(tmp_path))
    assert tflic._FLIC_COLUMNS == jflic._FLIC_COLUMNS
    kw = dict(source="flic", flic_dir=str(tmp_path), image_hw=(48, 64))
    want = jflic.load_flic(JaxDataConfig(**kw))
    got = tflic.load_flic(DataConfig(**kw))
    for g, w in zip(got, want):
        assert g["image"].dtype == np.uint8 and g["image"].shape == w["image"].shape
        for key in ("image", "joints", "visible"):
            np.testing.assert_array_equal(g[key], w[key])
    assert got[0]["visible"][1].sum() == 8 and got[0]["visible"][0].all()


def test_make_dataset_flic_is_host_resident(tmp_path):
    make_fake_flic(str(tmp_path), n_train=5, n_test=2)
    cfg = DataConfig(source="flic", flic_dir=str(tmp_path), image_hw=(48, 64))
    train, test = tpipe.make_dataset(cfg)  # needs no device: the split stays on the host
    jtrain, _ = jpipe.make_dataset(JaxDataConfig(**dataclasses.asdict(cfg)))
    assert (train.size, test.size) == (5, 2) and train.host_resident and test.host_resident
    idx = np.array([4, 0, 2], dtype=np.int32)
    got, want = train.get_batch(idx), jtrain.get_batch(idx)
    assert got["image"].dtype == torch.uint8 and got["image"].device.type == "cpu"
    for key in ("image", "joints", "visible"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert torch.equal(train.get_batch(torch.tensor([4, 0, 2]))["image"], got["image"])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_from_host_arrays_keeps_uint8(dtype):
    rs = np.random.RandomState(0)
    arrays = {"image": (rs.rand(6, 8, 10, 3) * 255).astype(dtype),
              "joints": rs.rand(6, 9, 2), "visible": np.ones((6, 9), np.int64)}
    ds = tpipe.from_host_arrays(arrays)
    got = ds.get_batch([1, 3])
    assert got["image"].dtype == (torch.uint8 if dtype == np.uint8 else torch.float32)
    assert got["joints"].dtype == got["visible"].dtype == torch.float32
    assert ds.size == 6 and ds.host_resident and ds.arrays["image"].shape == (6, 8, 10, 3)


def test_device_cache_is_a_sized_decision():
    rs = np.random.RandomState(1)
    arrays = {"image": (rs.rand(6, 8, 10, 3) * 255).astype(np.uint8),
              "joints": rs.rand(6, 9, 2).astype(np.float32),
              "visible": np.ones((6, 9), np.float32)}
    ds = tpipe.from_host_arrays(arrays)
    nbytes = sum(a.nbytes for a in ds.arrays.values())
    assert tpipe.device_cache(ds, nbytes - 1, "cpu") is ds  # over budget: untouched
    cached = tpipe.device_cache(ds, nbytes, "cpu")
    assert not cached.host_resident and cached.cache["image"].dtype == torch.uint8
    got, want = cached.get_batch(np.array([5, 0])), ds.get_batch(np.array([5, 0]))
    assert all(torch.equal(got[k], want[k]) for k in want)
    generated = tpipe.Dataset(size=4, get_batch=lambda i: {})
    assert tpipe.device_cache(generated, 1e12, "cpu") is generated


def test_unknown_source_raises():
    with pytest.raises(ValueError, match="unknown data source"):
        tpipe.make_dataset(DataConfig(source="imagenet"), "cpu")
