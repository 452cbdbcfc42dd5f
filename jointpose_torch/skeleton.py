"""FLIC skeleton definition: joint set, left/right flip permutation, limbs.

The reference (max-andr/joint-cnn-mrf; see SURVEY.md §1 "Data layer")
trains on FLIC upper-body annotations.  We use the canonical 9-joint
upper-body subset used in Tompson et al. (arXiv:1406.2984 §4) FLIC
evaluations: nose, shoulders, elbows, wrists, hips.  PDJ normalizes by
the torso diameter, defined (as in the FLIC eval protocol) as the
distance from the left shoulder to the right hip.
"""

from __future__ import annotations

JOINTS: tuple[str, ...] = (
    "nose",
    "lsho",
    "rsho",
    "lelb",
    "relb",
    "lwri",
    "rwri",
    "lhip",
    "rhip",
)

NUM_JOINTS: int = len(JOINTS)

JOINT_INDEX: dict[str, int] = {name: i for i, name in enumerate(JOINTS)}

# Permutation applied to the joint axis when an image is mirrored
# horizontally: left <-> right labels swap.  FLIP_PERM[i] = index of the
# joint that joint i becomes after the flip.
FLIP_PERM: tuple[int, ...] = tuple(
    JOINT_INDEX["r" + name[1:]]
    if name.startswith("l")
    else JOINT_INDEX["l" + name[1:]]
    if name.startswith("r")
    else JOINT_INDEX[name]
    for name in JOINTS
)

# Limbs (bones) used by the synthetic-FLIC renderer and visualization.
LIMBS: tuple[tuple[str, str], ...] = (
    ("nose", "lsho"),
    ("nose", "rsho"),
    ("lsho", "rsho"),
    ("lsho", "lelb"),
    ("lelb", "lwri"),
    ("rsho", "relb"),
    ("relb", "rwri"),
    ("lsho", "lhip"),
    ("rsho", "rhip"),
    ("lhip", "rhip"),
)

# Torso diameter endpoints for PDJ normalization (FLIC protocol:
# left shoulder to right hip).
TORSO_PAIR: tuple[str, str] = ("lsho", "rhip")

# Headline PDJ joints (BASELINE.json:2 — "PDJ@0.05 wrist/elbow parity").
HEADLINE_JOINTS: tuple[str, ...] = ("lelb", "relb", "lwri", "rwri")
