"""Typed configuration system with the five baseline presets.

The port's own copy of ``jointpose/configs.py``: the port imports
nothing of the JAX package, so the dataclasses and presets are kept
here verbatim and ``tests/test_torch_isolation.py`` checks that every
preset still equals the reference's.

Replaces the reference's ``tf.app.flags`` block (SURVEY.md C1) with
frozen dataclasses.  The five named presets correspond 1:1 to
``BASELINE.json`` configs 1-5:

1. ``single_scale`` — single-scale CNN part detector, heatmap regression,
   CPU-runnable.
2. ``multires``     — multi-resolution two-branch detector (full + half
   res) with heatmap fusion.
3. ``mrf``          — MRF spatial model: pairwise-prior large convs in
   log-space over joint heatmaps (on top of the multires detector).
4. ``joint``        — joint end-to-end CNN+MRF training with
   crop/scale/rotate augmentation.
5. ``eval_tta``     — batched eval: PDJ/PCK curves with flip-averaged TTA.

Plus auxiliary presets: ``tiny`` (CPU unit-test config), ``flagship``
(the throughput-tuned config benched by bench.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from jointpose_torch import skeleton


@dataclass(frozen=True)
class DetectorConfig:
    """Fully-convolutional part detector (SURVEY C5/C6; arXiv:1406.2984 §3.1).

    The trunk is ``len(trunk_features)`` stages of (conv k×k, ReLU,
    optional 2×2 maxpool); the number of pools fixes the heatmap stride.
    The head is the paper's "fully-connected-equivalent" wide convs:
    head_kernel×head_kernel×head_features[0], then 1×1 convs.
    """

    trunk_features: tuple[int, ...] = (64, 128, 128)
    trunk_kernel: int = 5
    # Which trunk stages are followed by a 2x2 maxpool; len == #pools.
    trunk_pool: tuple[bool, ...] = (True, True, False)
    # How pooled stages downsample: 'max' = conv -> ReLU -> 2x2 maxpool
    # (paper-faithful); 'stride' = stride-2 conv -> ReLU — same receptive
    # field and parameter shapes, but the full-resolution feature map is
    # never materialized, halving the stage's HBM traffic and quartering
    # its conv FLOPs (the flagship preset is bandwidth-bound there).
    pool_mode: str = "max"
    head_features: tuple[int, ...] = (512, 256)
    head_kernel: int = 9
    multires: bool = False
    # Share trunk weights across resolutions (paper-faithful); the half-res
    # branch reuses the full-res filter banks on the half-res pyramid level.
    share_trunk: bool = True
    # Wide-head conv implementation: 'direct' (lax conv), 'fft' (Fourier
    # matmuls, ops/fft_conv.py — 14x fewer FLOPs at the paper's 9x9x512
    # head with the half column spectrum), or 'auto' (closed-form
    # min(MXU, HBM)-roofline comparison per geometry and batch).
    # Parameter layout is identical across impls.
    head_conv_impl: str = "auto"


@dataclass(frozen=True)
class MRFConfig:
    """MRF spatial model (SURVEY C7; arXiv:1406.2984 §3.2).

    One sum-product message pass computed in log space:
        log p̄_A = Σ_v log( softplus(k_{A|v}) ⊛ p_v + softplus(b_{v,A}) )
    Kernels cover displacements up to ±(window_h//2, window_w//2) in
    heatmap pixels.  ``full extent`` = (2*Hm-1, 2*Wm-1); empirical priors
    are near-zero at extreme displacements so a bounded window is both
    faster and statistically identical (SURVEY §7 hard-parts #1).
    """

    # Odd (dy, dx) kernel extents in MRF-grid pixels.  (45, 67) at
    # heatmap stride 4 covers ±(88, 132) image px of displacement —
    # beyond any upper-body joint pair at FLIC scale (the empirical
    # priors are empty further out), at ~1/4 the taps of the full
    # (2*Hm-1, 2*Wm-1) extent.  Fully configurable for larger scenes.
    window: tuple[int, int] = (45, 67)
    eps: float = 1e-6  # floor inside log() — bf16-safe (SURVEY §7 #2)
    normalize_input: bool = True  # spatial-softmax detector maps before MRF
    # In the fft regime, selects the fused Pallas Fourier tail; in the
    # direct-conv regime select_impl always returns 'xla' (measured
    # faster at every production geometry — results/kernels/
    # mrf_coarse_times.json), so this flag has no effect there.  Set
    # impl='pallas' to force the fused epilogue explicitly.
    use_pallas: bool = True
    # Pairwise-conv implementation: 'auto' | 'xla' | 'pallas' | 'fft'.
    # 'fft' computes the K^2 large correlations as DFT matmuls on the
    # MXU (ops/mrf_fft.py) — ~12x fewer FLOPs than XLA's dense rewrite
    # of the grouped conv at the paper presets' stride-1 45x67 window.
    # 'auto' picks 'fft' for large stride-1 windows and the direct
    # grouped conv (+ fused Pallas epilogue per use_pallas) otherwise.
    impl: str = "auto"
    # Matmul precision inside the message pass: 'high' = fp32-exact
    # contractions (Mosaic rounds bf16x3 up to HIGHEST, ~6 MXU passes),
    # 'default' = single-pass bf16 with fp32 accumulation.  Measured on
    # the chip (round 3): the fused Fourier kernel runs ~4-6x faster at
    # 'default'; training keeps 'high' (the log epilogue's gradients
    # amplify small-response error) — flip inference surfaces to
    # 'default' only with a PDJ-parity check, see BASELINE.md.
    precision: str = "high"
    # MRF grid stride relative to the heatmap: 1 = paper-exact message
    # pass at heatmap resolution; 2 = TPU-native coarse variant — the
    # message pass runs on 2x2-pooled unaries (same physical window at
    # 1/16 the taps; displacement priors are smooth at this scale), the
    # log-messages are bilinearly upsampled, and the full-resolution
    # log-unary is added so localization stays sharp.
    stride: int = 1


@dataclass(frozen=True)
class AugmentConfig:
    """On-device crop/scale/rotate/flip augmentation (SURVEY C3)."""

    enabled: bool = True
    scale_range: tuple[float, float] = (0.7, 1.3)
    rotate_deg: float = 20.0
    translate_frac: float = 0.08  # max |shift| as fraction of image size
    flip_prob: float = 0.5
    # Explicit random crop (the reference's crop augmentation, SURVEY C3):
    # a sub-window of ``frac * (H, W)`` with frac ~ U(crop_frac_range) and
    # uniform in-frame origin is resampled back to (H, W).  (1.0, 1.0)
    # disables it (identity).  Applied before scale/rotate/flip; composed
    # into the same single affine, so it costs nothing extra.
    crop_frac_range: tuple[float, float] = (1.0, 1.0)
    # Image-resample implementation: 'gather' is map_coordinates
    # bilinear (the historical training stream); 'shear' is the
    # gather-free two-pass Pallas matmul resample
    # (jointpose/ops/warp_pallas.py) — ~400x less warp HBM traffic,
    # equally valid but different sample values under rotation, so
    # flipping it changes the (seed, step) training stream.
    warp_impl: str = "gather"


@dataclass(frozen=True)
class TrainConfig:
    """Optimization & staged schedule (SURVEY C8/C10)."""

    batch_size: int = 32
    learning_rate: float = 3e-4
    weight_decay: float = 1e-5
    optimizer: str = "adamw"  # adamw | momentum
    momentum: float = 0.9
    # LR schedule over the full staged run: 'constant' or 'cosine'
    # (linear warmup then cosine decay to lr_final_frac * lr).
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    lr_final_frac: float = 0.05
    # Loss on detector heatmaps: 'mse' (paper §3.3 per-pixel regression)
    # or 'ce' (per-joint spatial softmax cross-entropy).
    detector_loss: str = "mse"
    # Loss on MRF (normalized) output heatmaps.
    mrf_loss: str = "ce"
    # LR multiplier for the spatial-model subtree.  The K^2 pairwise
    # kernels see much smaller per-parameter gradients than the detector
    # (each tap touches one displacement of one joint pair), so the
    # frozen-detector regime (BASELINE config 3) converges impractically
    # slowly at the shared LR — raise this to train the MRF to plateau
    # without destabilizing the detector stages.
    mrf_lr_mult: float = 1.0
    # Staged regime [P1406 §3.3]: detector pretrain steps, then joint steps.
    detector_steps: int = 1000
    joint_steps: int = 1000
    # Freeze the detector during the joint stage (BASELINE config 3: the
    # spatial model trains on top of fixed unaries; config 4 trains
    # end-to-end).
    freeze_detector_in_joint: bool = False
    eval_every: int = 200
    log_every: int = 50
    # Train steps in one dispatch of train.fit (make_train_multistep for
    # on-device sources, make_train_multistep_arrays for host-resident
    # splits): on the card in a world of one process one CUDA graph of
    # the K steps, which spares the host's launches; bit-identical to K
    # single steps.  Chunks never cross log/eval/stage boundaries, so the
    # observable cadence is the same for any value.
    steps_per_dispatch: int = 10
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class DataConfig:
    """Dataset source & geometry (SURVEY C2/C4).

    FLIC frames are 720x480; the reference pipeline halves them.  All
    shapes are (height, width).  Heatmaps are rendered at
    ``image_hw / heatmap_stride`` with a Gaussian of ``sigma`` heatmap px.
    """

    source: str = "synthetic"  # synthetic | flic
    flic_dir: str = "/data/FLIC"
    # HBM budget (GB) for promoting a host-resident split to an
    # on-device source (data/pipeline.device_cache): splits under the
    # budget transfer once and gather on device (the train loop's
    # index-fused scan then applies — no per-step host->device pixel
    # streaming); larger splits keep the O(batch) host-streaming path.
    # 0 disables.  Single-process runs only (a multi-host cache would
    # need a sharded global array; hosts stream their local batches).
    # Default 0 (opt-in) because the right setting is HOST-dependent.
    # Measured on this rig's relay (2026-08-19): raw device_put runs at
    # ~300 MB/s, but (a) HOST-RESIDENT program arguments pay ~0.1 s/MB
    # on EVERY execution (the K=10 fused host stream's 83 MB/dispatch
    # → ~10 s/dispatch, 37 img/s — 20x under the device rate), and
    # (b) any big buffer pays a ONE-TIME ~0.4 s/MB processing cost per
    # (program, buffer) association, device-resident or not (1 GB
    # cache arg → 382 s first call; 133 MB closure constant → 53 s
    # compile; same per-MB rate) — after which device-resident args
    # are free.  So for a multi-hour run the cache wins despite the
    # ~6 min/program warmup, and training runs pass --device-cache-gb
    # explicitly.  On directly-attached hosts (PCIe) it simply wins.
    device_cache_gb: float = 0.0
    image_hw: tuple[int, int] = (240, 360)
    heatmap_stride: int = 4
    sigma: float = 1.5
    train_size: int = 3987  # canonical FLIC split sizes
    test_size: int = 1016
    seed: int = 1234


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for pjit sharding (SURVEY §2 parallelism table).

    ``data`` shards the batch (DP, gradient psum over ICI); ``model``
    shards the MRF's K^2 pairwise channels (the embarrassingly-parallel
    tensor axis this model has).  axis sizes of -1 mean "all available".
    """

    data: int = -1
    model: int = 1
    # Spatial parallelism: also shard detector-trunk image ROWS over the
    # 'model' axis (XLA SPMD halo exchanges; models/detector.py).
    spatial: bool = False


@dataclass(frozen=True)
class Config:
    name: str = "single_scale"
    data: DataConfig = field(default_factory=DataConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    mrf: MRFConfig | None = None
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Compute dtype for conv/matmul activations ('bfloat16' on TPU;
    # params & loss stay fp32 — SURVEY §7 build step 3).
    compute_dtype: str = "bfloat16"
    eval_flip_tta: bool = False
    # Sub-heatmap-pixel decode: 3x3 value-weighted centroid around the
    # argmax.  False = reference-parity plain argmax; True removes most
    # of the stride-quantization error (a capability beyond the
    # reference, enabled on eval_tta and flagship).
    decode_refine: bool = False

    @property
    def num_joints(self) -> int:
        return skeleton.NUM_JOINTS

    @property
    def heatmap_hw(self) -> tuple[int, int]:
        h, w = self.data.image_hw
        s = self.data.heatmap_stride
        assert h % s == 0 and w % s == 0, (h, w, s)
        return (h // s, w // s)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _preset_single_scale() -> Config:
    # BASELINE config 1: single-scale detector, heatmap regression,
    # CPU-runnable (fp32 on CPU; the dtype is overridden there).
    # Augmentation arrives with config 4 (its BASELINE description).
    return Config(name="single_scale", augment=AugmentConfig(enabled=False))


def _preset_multires() -> Config:
    # BASELINE config 2: two-branch detector with heatmap fusion.
    return Config(
        name="multires",
        detector=DetectorConfig(multires=True),
        augment=AugmentConfig(enabled=False),
    )


def _preset_mrf() -> Config:
    # BASELINE config 3: MRF spatial model on top of the detector.
    # The spatial model trains on top of the FROZEN pretrained detector
    # (end-to-end fine-tuning is config 4).
    return Config(
        name="mrf",
        detector=DetectorConfig(multires=True),
        mrf=MRFConfig(),
        augment=AugmentConfig(enabled=False),
        train=TrainConfig(freeze_detector_in_joint=True),
    )


def _preset_joint() -> Config:
    # BASELINE config 4: joint end-to-end CNN+MRF training + augmentation.
    return Config(
        name="joint",
        detector=DetectorConfig(multires=True),
        mrf=MRFConfig(),
        augment=AugmentConfig(enabled=True, crop_frac_range=(0.8, 1.0)),
    )


def _preset_eval_tta() -> Config:
    # BASELINE config 5: batched eval, PDJ/PCK curves, flip-averaged TTA.
    return _preset_joint().replace(
        name="eval_tta", eval_flip_tta=True, decode_refine=True
    )


def _preset_tiny() -> Config:
    # CPU unit/integration-test config: tiny shapes, tiny widths.
    return Config(
        name="tiny",
        data=DataConfig(
            image_hw=(48, 64),
            sigma=1.0,
            train_size=16,
            test_size=8,
        ),
        detector=DetectorConfig(
            trunk_features=(8, 16),
            trunk_pool=(True, True),
            head_features=(32, 16),
            head_kernel=5,
            multires=True,
        ),
        mrf=MRFConfig(window=(11, 15), use_pallas=False),
        train=TrainConfig(
            batch_size=4,
            detector_steps=30,
            joint_steps=30,
            eval_every=10,
            log_every=10,
        ),
        mesh=MeshConfig(data=1, model=1),
        compute_dtype="float32",
    )


def _preset_flagship() -> Config:
    # Throughput-tuned flagship for bench.py: multires detector + MRF,
    # bf16 compute, widths sized so >=10k img/s/chip is comfortably
    # cleared on a v5e-class chip (BASELINE.json:5) while keeping the
    # paper topology.  pool_mode='stride' folds the 2x2 maxpools into
    # stride-2 convs: the full-resolution trunk feature maps (the
    # dominant HBM traffic of this bandwidth-bound model) are never
    # materialized — cost_analysis 7.4 -> 6.0 GFLOP/img and 54 -> 40
    # MB/img, min(MXU, HBM) roofline 12.2k -> 16.6k img/s/chip, with
    # PDJ parity verified by a full retrain (BASELINE.md).
    return Config(
        name="flagship",
        detector=DetectorConfig(
            trunk_features=(24, 48, 96),
            trunk_pool=(True, True, False),
            head_features=(128, 96),
            head_kernel=5,
            multires=True,
            pool_mode="stride",
        ),
        mrf=MRFConfig(window=(17, 25), stride=2),
        # Pallas shear warp is the flagship training default since the
        # round-4 shear retrain hit full parity (0.9879 refine / 0.9899
        # TTA full-split, results/flagship_shear_r4/ vs gather's
        # 0.984/0.990) — the advertised training throughput (2,727
        # img/s on the production materialized-uint8 stream,
        # results/train_throughput/train_times.json) and the advertised
        # accuracy now describe the SAME configuration.
        augment=AugmentConfig(enabled=True, warp_impl="shear"),
        eval_flip_tta=False,
        decode_refine=True,
    )


def _preset_flagship_slim() -> Config:
    # The flagship with a 3x3 head conv: 6.0 -> 3.9 GFLOP/img, roofline
    # 19.9k -> 24.5k img/s/chip (uint8 ingest).  At the 8000+8000-step
    # schedule the PDJ cost is small — 0.980 refine / 0.987 TTA
    # full-split vs the flagship's 0.984 / 0.990
    # (results/flagship_slim_long/) — making this the
    # throughput-per-accuracy sweet spot; the flagship stays the
    # headline.
    cfg = _preset_flagship()
    return cfg.replace(
        name="flagship_slim",
        detector=dataclasses.replace(cfg.detector, head_kernel=3),
        # Like the flagship, slim trains on the Pallas shear stream: the
        # round-4 8000+8000-step retrain on shear scores 0.9801 refine /
        # 0.9852 TTA full-split (results/flagship_slim_shear_r4/) vs the
        # gather stream's 0.980/0.987 (results/flagship_slim_long/) —
        # stream parity within noise, so slim's measured training speed
        # and its recorded accuracy describe the same configuration.
        # (warp_impl='shear' is inherited from the flagship preset.)
    )


PRESETS = {
    "single_scale": _preset_single_scale,
    "multires": _preset_multires,
    "mrf": _preset_mrf,
    "joint": _preset_joint,
    "eval_tta": _preset_eval_tta,
    "tiny": _preset_tiny,
    "flagship": _preset_flagship,
    "flagship_slim": _preset_flagship_slim,
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown config preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


def with_pool_mode(config: Config, pool_mode: str) -> Config:
    """Config with the detector trunk's downsampling mode replaced.

    The two modes ('max' pool vs folded stride-2 convs) share parameter
    shapes by design, so checkpoints restore across them — but silently
    mis-evaluate on a mismatch.  Every CLI override and every
    checkpoint-metadata reconciliation goes through this one helper.
    """
    return config.replace(
        detector=dataclasses.replace(config.detector, pool_mode=pool_mode)
    )


def with_mrf_precision(config: Config, precision: str) -> Config:
    """Config with the MRF message-pass matmul precision replaced.

    'default' is one reduced-precision pass with fp32 accumulation in the
    Fourier paths (on the card one TF32 pass; the reference's bar for it
    is 0.4% max relative output error); serving defaults to it, training
    keeps 'high'.  No-op for MRF-less configs.
    """
    assert precision in ("high", "default"), precision
    if config.mrf is None:
        return config
    return config.replace(
        mrf=dataclasses.replace(config.mrf, precision=precision)
    )
