"""Batched input pipeline over pluggable sources (counterpart of
``jointpose/data/pipeline.py``).

One interface over the on-device synthetic source and the host-array
FLIC source: a ``Dataset`` hands out batches keyed by integer example
indices, so shuffling is a host-side permutation of int32 indices (numpy,
bit-equal to the reference's for the same ``np.random.Generator``) and
all per-pixel work stays on the dataset's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from jointpose_torch.configs import DataConfig


@dataclasses.dataclass
class Dataset:
    """A split: ``get_batch(indices (B,) int) -> dict`` of batch tensors.

    Batch dict keys: image (B, H, W, 3) float32 in [0, 1] or uint8;
    joints (B, K, 2) (x, y) image px; visible (B, K) float32.  The
    synthetic source returns tensors on its device; a host-resident
    split (FLIC) returns CPU tensors and the consumer moves the batch, so
    device memory stays O(batch) whatever the split's size.
    """

    size: int
    get_batch: Callable[[np.ndarray], dict]
    # True when the split's full arrays live in host memory and get_batch
    # slices there; see device_cache() for parking a small split on the device.
    host_resident: bool = False
    # The backing host arrays of a host-resident split; None for generated sources.
    arrays: dict | None = None
    # device_cache only: the device-resident tensors.
    cache: dict | None = None


def as_index(indices) -> torch.Tensor:
    """Example indices (a sequence, numpy array or tensor) as a tensor."""
    return indices if torch.is_tensor(indices) else torch.as_tensor(np.asarray(indices))


def make_dataset(
    cfg: DataConfig, device: str | torch.device | None = None
) -> tuple[Dataset, Dataset]:
    """Build (train, test) datasets for the configured source.  The
    synthetic source generates on ``device`` (CUDA unless the caller asks
    for the CPU); the FLIC source stays in host memory."""
    if cfg.source == "synthetic":
        from jointpose_torch.data.synthetic import make_synthetic_flic
        from jointpose_torch.predict import resolve_device

        gen = make_synthetic_flic(cfg, resolve_device(device))
        train = Dataset(size=cfg.train_size, get_batch=gen)
        # Test indices offset past the train range => disjoint examples.
        offset = cfg.train_size

        def get_test(indices):
            return gen(as_index(indices) + offset)

        return train, Dataset(size=cfg.test_size, get_batch=get_test)

    if cfg.source == "flic":
        from jointpose_torch.data.flic import load_flic

        train_arrays, test_arrays = load_flic(cfg)
        return from_host_arrays(train_arrays), from_host_arrays(test_arrays)

    raise ValueError(f"unknown data source {cfg.source!r}")


def from_host_arrays(arrays: dict) -> Dataset:
    """Dataset over host-resident numpy arrays with O(batch) staging:
    ``get_batch`` slices a numpy batch and hands it out as CPU tensors.
    uint8 image splits stay uint8 end to end (a quarter of the host
    memory and of the per-batch transfer); the model's normalize or the
    augmentation warp converts on the device."""
    src = np.asarray(arrays["image"])
    image = np.ascontiguousarray(src, dtype=np.uint8 if src.dtype == np.uint8 else np.float32)
    joints = np.ascontiguousarray(arrays["joints"], dtype=np.float32)
    visible = np.ascontiguousarray(arrays["visible"], dtype=np.float32)

    def get_batch(indices) -> dict:
        idx = as_index(indices).cpu().numpy()
        return {
            "image": torch.from_numpy(image[idx]),
            "joints": torch.from_numpy(joints[idx]),
            "visible": torch.from_numpy(visible[idx]),
        }

    return Dataset(
        size=int(image.shape[0]), get_batch=get_batch, host_resident=True,
        arrays={"image": image, "joints": joints, "visible": visible},
    )


def device_cache(ds: Dataset, max_bytes: float, device: str | torch.device) -> Dataset:
    """Promote a host-resident split to a device-resident source when its
    arrays fit ``max_bytes``: one transfer up front, then ``get_batch``
    is a gather on the device.  uint8 images stay uint8.  Splits over the
    budget, and generated sources, pass through untouched."""
    if not ds.host_resident or ds.arrays is None:
        return ds
    if sum(a.nbytes for a in ds.arrays.values()) > max_bytes:
        return ds
    dev = {k: torch.from_numpy(v).to(device) for k, v in ds.arrays.items()}

    def get_batch(indices) -> dict:
        idx = as_index(indices).to(device, torch.int64)
        return {k: v[idx] for k, v in dev.items()}

    return Dataset(size=ds.size, get_batch=get_batch, host_resident=False, cache=dev)


def epoch_order(n: int, batch_size: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """One epoch's example order, wrapped up to at least one batch.

    When the split is smaller than a batch, indices wrap (sampling with
    replacement within the epoch) so tiny test configs still train.
    """
    order = np.arange(max(n, batch_size), dtype=np.int32) % n
    if rng is not None:
        rng.shuffle(order)
    return order


def batch_iterator(
    dataset: Dataset, batch_size: int, rng: np.random.Generator | None = None,
    drop_remainder: bool = True,
) -> Iterator[np.ndarray]:
    """Yield index arrays for one epoch (shuffled when ``rng`` is given)."""
    order = epoch_order(dataset.size, batch_size, rng)
    end = len(order) if drop_remainder else len(order) + batch_size - 1
    for start in range(0, end - batch_size + 1, batch_size):
        yield order[start : start + batch_size]


def epoch_steps(dataset: Dataset, batch_size: int) -> int:
    return max(dataset.size, batch_size) // batch_size
