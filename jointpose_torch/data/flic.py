"""Real FLIC dataset loader (own copy of ``jointpose/data/flic.py``: numpy,
scipy and PIL only).

Parses FLIC's MATLAB annotation file ``examples.mat`` (fields per
example: filepath, coords 2x29, istrain/istest flags) and loads the
720x480 JPEG frames, resized to the working resolution with joint
coordinates rescaled to match.  Used only when ``DataConfig.source`` is
``'flic'`` and ``DataConfig.flic_dir`` holds the dataset; every preset
defaults to the synthetic source.  The joint-column mapping follows the
published FLIC annotation order.
"""

from __future__ import annotations

import os

import numpy as np

from jointpose_torch import skeleton
from jointpose_torch.configs import DataConfig

# FLIC ``coords`` is 2 x 29; MATLAB 1-based column -> joint name for the
# columns we consume (the rest are lower-body/face points the reference
# does not use).  Nose is the average of eyes when the nose column is NaN.
_FLIC_COLUMNS = {
    "lsho": 1,
    "lelb": 2,
    "lwri": 3,
    "rsho": 4,
    "relb": 5,
    "rwri": 6,
    "lhip": 7,
    "rhip": 10,
    "leye": 13,
    "reye": 14,
    "nose": 17,
}


def load_flic(cfg: DataConfig):
    """Load FLIC into host arrays.

    Returns (train, test) dicts with keys:
      image   (N, H, W, 3) uint8 RGB (a quarter of the host memory and of
              the per-batch transfer of fp32; every consumer accepts
              uint8, the model normalizes it)
      joints  (N, K, 2) float32, (x, y) at the working resolution
      visible (N, K) float32
    """
    import scipy.io  # deferred; only needed for real FLIC

    mat_path = os.path.join(cfg.flic_dir, "examples.mat")
    if not os.path.exists(mat_path):
        raise FileNotFoundError(
            f"FLIC annotations not found at {mat_path}; use source='synthetic' "
            "(the default) when real FLIC is unavailable."
        )
    mat = scipy.io.loadmat(mat_path, squeeze_me=True, struct_as_record=False)
    examples = mat["examples"]

    h, w = cfg.image_hw
    splits = {True: {"image": [], "joints": [], "visible": []},
              False: {"image": [], "joints": [], "visible": []}}

    from PIL import Image  # deferred like scipy

    for ex in np.atleast_1d(examples):
        is_train = bool(ex.istrain)
        img_path = os.path.join(cfg.flic_dir, "images", str(ex.filepath))
        with Image.open(img_path) as im:
            src_w, src_h = im.size
            im = im.convert("RGB").resize((w, h), Image.BILINEAR)
            img = np.asarray(im, dtype=np.uint8)
        coords = np.asarray(ex.coords, dtype=np.float64)  # (2, 29)
        sx, sy = w / src_w, h / src_h

        joints = np.zeros((skeleton.NUM_JOINTS, 2), np.float32)
        visible = np.zeros((skeleton.NUM_JOINTS,), np.float32)
        for j, name in enumerate(skeleton.JOINTS):
            if name == "nose":
                xy = coords[:, _FLIC_COLUMNS["nose"] - 1]
                if np.any(np.isnan(xy)):
                    le = coords[:, _FLIC_COLUMNS["leye"] - 1]
                    re = coords[:, _FLIC_COLUMNS["reye"] - 1]
                    xy = (le + re) / 2.0
            else:
                xy = coords[:, _FLIC_COLUMNS[name] - 1]
            if np.any(np.isnan(xy)):
                continue
            joints[j] = [xy[0] * sx, xy[1] * sy]
            visible[j] = 1.0

        split = splits[is_train]
        split["image"].append(img)
        split["joints"].append(joints)
        split["visible"].append(visible)

    def pack(d):
        return {
            "image": np.stack(d["image"]),
            "joints": np.stack(d["joints"]),
            "visible": np.stack(d["visible"]),
        }

    return pack(splits[True]), pack(splits[False])
