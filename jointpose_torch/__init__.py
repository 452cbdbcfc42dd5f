"""jointpose_torch — the PyTorch/CUDA port of ``jointpose``.

A second package beside the JAX reference, training, evaluating and
serving the same joint CNN+MRF pose model on an NVIDIA H100.  Plain tensor code is PyTorch;
each Pallas kernel of the reference on this package's path is a CUDA
kernel written by hand under ``csrc/`` and built at first use
(``_build.py``).  Public functions keep the reference's layouts: NHWC
images and (B, H, W, K) heatmaps.

- ``jointpose_torch.models``  — Detector, SpatialModel, PoseModel.
- ``jointpose_torch.ops``     — heatmap maths and the MRF message passes
                                (direct, coarse, Fourier), with the two
                                CUDA kernels' wrappers and plain versions.
- ``jointpose_torch.data``    — the synthetic source (generated on the
                                device), the FLIC loader, the batch
                                pipeline, augmentation and targets.
- ``jointpose_torch.train``   — the training step and ``fit`` (staged
                                training, evals, checkpoints, resume).
- ``jointpose_torch.priors``, ``evaluate``, ``metrics``, ``checkpoint``
                              — what ``fit`` is made of.
- ``jointpose_torch.predict`` — ``build_predictor``, ``restore_params``,
                                seeded weights and the batch-inference CLI.
- ``jointpose_torch.serve``   — the HTTP inference server.
- ``jointpose_torch.ops.quant``, ``quantize``
                              — the int8 post-training-quantized detector
                                and its artifact CLI.
- ``jointpose_torch.visualize`` — heatmap overlays, priors, PDJ curves.
- ``jointpose_torch.resilience`` — preemption, heartbeat, fault injection
                                and the supervisor of a training run.
- ``jointpose_torch.perf``, ``devtime``, ``debug``, ``cli``
                              — the card's peaks and a step's cost, device
                                time from profiler traces, numerics
                                checks, the entry points' shared flags.
- ``jointpose_torch.convert`` — flax params tree -> torch ``state_dict``.

The package never imports ``jax`` or anything of ``jointpose``.
"""

__version__ = "0.1.0"

from jointpose_torch import skeleton  # noqa: F401
from jointpose_torch.configs import Config, get_config, PRESETS  # noqa: F401
