"""Post-training int8 quantization of the part detector (counterpart of
``jointpose/ops/quant.py``).

The reference's scheme:
- weights: per-output-channel symmetric int8, scale = amax / 127;
- activations: per-tensor symmetric int8 with static scales from a
  calibration pass (amax of each conv's input over the calibration images);
- every conv: s8 × s8 -> exact s32, then the fp32 epilogue
  ``y * (in_scale * w_scale) + bias``, ReLU, and the requantize straight to
  the next conv's input scale, so inter-layer tensors are int8;
- the 2×2 max pool runs on int8 (max commutes with the monotone requant);
- the multires sum runs in int16 at the head conv's input scale and clips
  back to the int8 lattice;
- the wide head conv is always a direct int8 conv, whatever
  ``head_conv_impl`` says.

The int8 conv has two routes, chosen by the device of its input, both
exact and so bit-equal: on CUDA an im2col of the int8 activations and one
``torch._int_mm`` (PyTorch has no int8 convolution on CUDA); on the CPU an
int32 ``F.conv2d``.  The int8 conv is no TPU kernel: the reference hands
it to XLA (``conv_general_dilated(..., preferred_element_type=int32)``).

The calibration graph replicates ``models/detector.Detector`` in fp32
(cuDNN's TF32 off for the call) and records amax at every conv input.
A deployment artifact is the reference's npz (``"{conv}|{field}"`` keys,
``w_q`` in HWIO), so each package reads the other's.

    qparams = quantize_detector(config, state_dict, calib_images)
    save_quantized("int8.npz", qparams)
    predict = build_quantized_predictor(config, state_dict, qparams=load_quantized("int8.npz"))
    coords, probs = predict(images_uint8_nhwc)
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jointpose_torch.configs import Config, DetectorConfig
from jointpose_torch.models.detector import _pool2x2, _upsample2x
from jointpose_torch.models.pose import make_logits_tail_fn
from jointpose_torch.ops.mrf_xla import same_pad
from jointpose_torch.predict import predictor_for, resolve_device

_QMAX = 127.0
FIELDS = ("w_q", "w_scale", "bias", "in_scale")


def _conv_names(cfg: DetectorConfig) -> list[str]:
    """The detector's convs in forward order, by the reference's names."""
    if cfg.share_trunk:
        trunks = ["trunk"]
    elif cfg.multires:
        trunks = ["trunk_full", "trunk_half"]
    else:
        # The detector has no trunk_half without multires.
        trunks = ["trunk_full"]
    names = [f"{t}/conv{i}" for t in trunks for i in range(len(cfg.trunk_features))]
    names.append("head_wide")
    names += [f"head_1x1_{i}" for i in range(len(cfg.head_features) - 1)]
    names.append("head_out")
    return names


def _lookup(state_dict: Mapping, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(weight OIHW, bias) of a conv in a ``PoseModel`` state_dict:
    'trunk/conv0' is ``detector.trunk.conv0.{weight,bias}``."""
    key = "detector." + name.replace("/", ".")
    return state_dict[f"{key}.weight"], state_dict[f"{key}.bias"]


def _trunks(cfg: DetectorConfig) -> tuple[str, str]:
    """Names of the full- and half-resolution trunks."""
    return ("trunk", "trunk") if cfg.share_trunk else ("trunk_full", "trunk_half")


def _stride(cfg: DetectorConfig, i: int) -> int:
    return 2 if cfg.trunk_pool[i] and cfg.pool_mode == "stride" else 1


def _normalize(images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> the detector's input in [-1, 1], fp32.  uint8 is
    divided by 255 as the reference does; the divisor is a tensor on the
    images' device, since CUDA turns a division by a host scalar into a
    product with its reciprocal, one rounding away (``torch.full`` makes
    it without a host copy, so the forward can be captured in a CUDA
    graph)."""
    if images.dtype == torch.uint8:
        images = images.float() / torch.full((), 255.0, device=images.device)
    return (images.float() - 0.5) * 2.0


def _avg_pyramid(x: torch.Tensor) -> torch.Tensor:
    """2×2 mean of an NCHW map with even H, W, summed in one fixed order
    (row-major over the window, as the reference's window sum), so that
    the card and the CPU round it alike: a last-bit difference here would
    move an int8 rounding of the half-resolution branch."""
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2])
            + x[..., 1::2, 1::2]) / 4.0


def _pool_int(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 SAME max pool of an integer NCHW map: an odd edge is padded
    with the dtype's minimum."""
    h, w = x.shape[-2:]
    x = F.pad(x, (0, w % 2, 0, h % 2), value=torch.iinfo(x.dtype).min)
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


@contextlib.contextmanager
def fp32_convs(device: torch.device):
    """Run the enclosed cuDNN convolutions in full fp32 (TF32 off); the flag
    is put back on exit.  CPU convolutions are fp32 either way."""
    if device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    # The newer per-operator setting where this PyTorch has it: mixing it
    # with the legacy allow_tf32 makes the legacy getter raise.
    obj, attr, value = ((cudnn.conv, "fp32_precision", "ieee")
                        if hasattr(getattr(cudnn, "conv", None), "fp32_precision")
                        else (cudnn, "allow_tf32", False))
    prev = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, prev)


def _fp_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """fp32 SAME conv of an NCHW map, then the bias (the reference's order)."""
    k = weight.shape[-1]
    (ht, hb), (wl, wr) = same_pad(x.shape[-2], k, stride), same_pad(x.shape[-1], k, stride)
    if ht == hb and wl == wr:
        y = F.conv2d(x, weight, stride=stride, padding=(ht, wl))
    else:
        y = F.conv2d(F.pad(x, (wl, wr, ht, hb)), weight, stride=stride)
    return y + bias[:, None, None]


def _fp_forward(cfg: DetectorConfig, state_dict: Mapping, images: torch.Tensor,
                amax: dict | None = None) -> torch.Tensor:
    """fp32 replica of ``Detector.forward`` (always the direct head conv),
    on the images' device with the weights already there.  With ``amax``
    it also records the running abs-max of every conv's input: the
    activation edges of the quantized graph."""
    stride_conv = cfg.pool_mode == "stride"

    def conv(name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        if amax is not None:
            m = x.abs().amax()
            amax[name] = torch.maximum(amax[name], m) if name in amax else m
        weight, bias = _lookup(state_dict, name)
        return _fp_conv(x, weight, bias, stride)

    def trunk(x: torch.Tensor, prefix: str) -> torch.Tensor:
        for i in range(len(cfg.trunk_features)):
            x = F.relu(conv(f"{prefix}/conv{i}", x, _stride(cfg, i)))
            if cfg.trunk_pool[i] and not stride_conv:
                x = _pool2x2(x)
        return x

    x = _normalize(images).permute(0, 3, 1, 2)
    t_full, t_half = _trunks(cfg)
    full = trunk(x, t_full)
    if cfg.multires:
        full = full + _upsample2x(trunk(_avg_pyramid(x), t_half))
    y = F.relu(conv("head_wide", full))
    for i in range(len(cfg.head_features) - 1):
        y = F.relu(conv(f"head_1x1_{i}", y))
    return conv("head_out", y).permute(0, 2, 3, 1)


def _detector_weights(state_dict: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: v.to(device, torch.float32) for k, v in state_dict.items()
            if k.startswith("detector.")}


def fp_reference_logits(config: Config, state_dict: Mapping, images: torch.Tensor) -> torch.Tensor:
    """The calibration graph's logits (B, Hm, Wm, K), on the images' device."""
    device = images.device
    with torch.inference_mode(), fp32_convs(device):
        return _fp_forward(config.detector, _detector_weights(state_dict, device), images)


def calibrate_detector(config: Config, state_dict: Mapping, calib_images: torch.Tensor,
                       batch_size: int = 32,
                       device: str | torch.device | None = None) -> dict[str, float]:
    """Run fp32 calibration batches on ``device``; return each conv's
    input scale, max(amax, 1e-6) / 127 (Python floats)."""
    device = resolve_device(device)
    weights = _detector_weights(state_dict, device)
    scales: dict[str, float] = {}
    with torch.inference_mode(), fp32_convs(device):
        for start in range(0, calib_images.shape[0], batch_size):
            amax: dict = {}
            _fp_forward(config.detector, weights, calib_images[start:start + batch_size].to(device),
                        amax)
            for k, v in amax.items():
                scales[k] = max(scales.get(k, 0.0), float(v))
    return {k: max(v, 1e-6) / _QMAX for k, v in scales.items()}


def quantize_detector(config: Config, state_dict: Mapping, calib_images: torch.Tensor,
                      device: str | torch.device | None = None) -> dict:
    """PTQ: a trained ``PoseModel`` state_dict + calibration images -> qparams,
    ``{conv name: {"w_q" int8 (out, in, kh, kw), "w_scale" fp32 (out,),
    "bias" fp32 (out,), "in_scale" fp32 ()}}``, on ``device``."""
    in_scales = calibrate_detector(config, state_dict, calib_images, device=device)
    device = resolve_device(device)
    q: dict = {}
    for name in _conv_names(config.detector):
        weight, bias = _lookup(state_dict, name)
        w = weight.to(device, torch.float32)
        # A divisor on the device: see _normalize.
        w_scale = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / torch.full((), _QMAX, device=device)
        q[name] = {
            "w_q": (w / w_scale[:, None, None, None]).round().clamp(-_QMAX, _QMAX).to(torch.int8),
            "w_scale": w_scale,
            "bias": bias.to(device, torch.float32),
            "in_scale": torch.tensor(in_scales[name], dtype=torch.float32, device=device),
        }
    return q


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def im2col_int8(xq: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Patches of an int8 NCHW map under a k×k SAME conv: (B·Ho·Wo, Kp)
    int8, each row (kh, kw, C) in HWIO order with zeros (the symmetric
    zero point) padded to Kp = K rounded up to 8, as ``torch._int_mm``
    asks."""
    b, c, h, w = xq.shape
    (ht, hb), (wl, wr) = same_pad(h, kernel, stride), same_pad(w, kernel, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    x = xq.permute(0, 2, 3, 1)
    if ht or hb or wl or wr:
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
    patches = x.unfold(1, kernel, stride).unfold(2, kernel, stride)  # (B, Ho, Wo, C, kh, kw)
    patches = patches.permute(0, 1, 2, 4, 5, 3)
    k = kernel * kernel * c
    kp = _round_up(k, 8)
    if kp == k:
        return patches.reshape(b * ho * wo, k)
    cols = torch.zeros(b * ho * wo, kp, dtype=torch.int8, device=xq.device)
    cols.view(b, ho, wo, kp)[..., :k].view(b, ho, wo, kernel, kernel, c).copy_(patches)
    return cols


def weight_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """int8 OIHW weights as an (Np, Kp) matrix, rows in HWIO order, padded
    with zeros to multiples of 8."""
    o, c, kh, kw = w_q.shape
    k = kh * kw * c
    wm = torch.zeros(_round_up(o, 8), _round_up(k, 8), dtype=torch.int8, device=w_q.device)
    wm[:o, :k] = w_q.permute(0, 2, 3, 1).reshape(o, k)
    return wm


def int_conv_im2col(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The card's route: im2col, then one s8 × s8 -> s32 ``torch._int_mm``.
    int8 NCHW in, int32 NCHW out (channels-last in memory)."""
    b, _, h, w = xq.shape
    o, kernel = w_q.shape[0], w_q.shape[-1]
    ho, wo = -(-h // stride), -(-w // stride)
    wm = weight_matrix(w_q)
    y = torch._int_mm(im2col_int8(xq, kernel, stride), wm.t())
    return y.view(b, ho, wo, wm.shape[0])[..., :o].permute(0, 3, 1, 2)


def int_conv_plain(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The CPU's route: an int32 SAME conv, exact.  int8 NCHW in, int32 out."""
    k = w_q.shape[-1]
    (ht, hb), (wl, wr) = same_pad(xq.shape[-2], k, stride), same_pad(xq.shape[-1], k, stride)
    x = F.pad(xq.to(torch.int32), (wl, wr, ht, hb))
    return F.conv2d(x, w_q.to(torch.int32), stride=stride)


def int_conv(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """s8 SAME conv with exact s32 sums, by the route of the input's device."""
    if xq.device.type == "cuda":
        return int_conv_im2col(xq, w_q, stride)
    if xq.device.type == "cpu":
        return int_conv_plain(xq, w_q, stride)
    raise ValueError(f"int_conv: no route for device {xq.device}")


def quant_detector_logits(config: Config, qparams: Mapping, images: torch.Tensor,
                          accumulators: dict | None = None) -> torch.Tensor:
    """int8 detector forward: NHWC images (float in [0, 1] or raw uint8) ->
    fp32 logits (B, Hm, Wm, K), on the images' device.  Every inter-conv
    tensor is int8.  With ``accumulators`` (a dict) each conv's int8 input
    and int32 sums are appended, as a pair, to a list under its name."""
    cfg = config.detector
    stride_conv = cfg.pool_mode == "stride"
    device = images.device
    q = {name: {f: t.to(device) for f, t in node.items()} for name, node in qparams.items()}

    def requant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return (x / scale).round().clamp(-_QMAX, _QMAX).to(torch.int8)

    def qconv(name: str, xq: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """s8 conv + fp32 epilogue (dequant, bias) -> fp32 pre-activation."""
        p = q[name]
        y = int_conv(xq, p["w_q"], stride)
        if accumulators is not None:
            accumulators.setdefault(name, []).append((xq, y))
        scale = (p["in_scale"] * p["w_scale"])[:, None, None]
        return y.float() * scale + p["bias"][:, None, None]

    def trunk(xq: torch.Tensor, prefix: str) -> torch.Tensor:
        """int8 input -> int8 features at the head conv's input scale."""
        n = len(cfg.trunk_features)
        for i in range(n):
            y = F.relu(qconv(f"{prefix}/conv{i}", xq, _stride(cfg, i)))
            # Requantize straight to the next edge's scale; pooling then
            # runs on int8.
            nxt = f"{prefix}/conv{i + 1}" if i + 1 < n else "head_wide"
            xq = requant(y, q[nxt]["in_scale"])
            if cfg.trunk_pool[i] and not stride_conv:
                xq = _pool_int(xq)
        return xq

    x = _normalize(images).permute(0, 3, 1, 2)
    t_full, t_half = _trunks(cfg)
    full_q = trunk(requant(x, q[f"{t_full}/conv0"]["in_scale"]), t_full)
    if cfg.multires:
        half_q = trunk(requant(_avg_pyramid(x), q[f"{t_half}/conv0"]["in_scale"]), t_half)
        # Both branches sit at head_wide's input scale; ReLU outputs are
        # >= 0, so the calibrated sum bounds each branch, and the int16 sum
        # clips back to the int8 lattice.
        fused = full_q.to(torch.int16) + _upsample2x(half_q).to(torch.int16)
        full_q = fused.clamp(-127, 127).to(torch.int8)
    y = F.relu(qconv("head_wide", full_q))
    for i in range(len(cfg.head_features) - 1):
        name = f"head_1x1_{i}"
        y = F.relu(qconv(name, requant(y, q[name]["in_scale"])))
    return qconv("head_out", requant(y, q["head_out"]["in_scale"])).permute(0, 2, 3, 1)


def save_quantized(path: str, qparams: Mapping) -> None:
    """Write a deployment artifact: the reference's npz, int8 weights in
    HWIO (about a quarter of the fp32 parameters' bytes)."""
    flat = {}
    for name, node in qparams.items():
        for field, t in node.items():
            arr = t.detach().cpu().numpy()
            if field == "w_q":
                arr = arr.transpose(2, 3, 1, 0).copy()  # OIHW -> HWIO
            flat[f"{name}|{field}"] = arr
    np.savez(path, **flat)


def load_quantized(path: str) -> dict:
    """Read a ``save_quantized`` artifact (this package's or the
    reference's) into qparams on the CPU, ``w_q`` back in OIHW."""
    q: dict = {}
    with np.load(path) as z:
        for key in z.files:
            name, field = key.rsplit("|", 1)
            arr = z[key]
            if field == "w_q":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            q.setdefault(name, {})[field] = torch.from_numpy(arr.copy())
    return q


class QuantizedPoseModel(nn.Module):
    """The int8 detector and the float MRF tail: images (B, H, W, 3) ->
    the ``PoseModel`` output dict.  The quantized tensors are buffers, so
    ``.to(device)`` moves them and ``evaluate`` finds the model's device
    even without an MRF."""

    def __init__(self, config: Config, qparams: Mapping, tail: nn.Module):
        super().__init__()
        self.config = config
        self.names = list(qparams)
        self.convs = nn.ModuleList()
        for name in self.names:
            conv = nn.Module()
            for field in FIELDS:
                conv.register_buffer(field, qparams[name][field])
            self.convs.append(conv)
        self.tail = tail

    def qparams(self) -> dict:
        return {name: {f: getattr(conv, f) for f in FIELDS}
                for name, conv in zip(self.names, self.convs)}

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.tail(quant_detector_logits(self.config, self.qparams(), images))


def make_quantized_apply_fn(config: Config, state_dict: Mapping, calib_images=None,
                            qparams: Mapping | None = None,
                            device: str | torch.device | None = None) -> QuantizedPoseModel:
    """The quantized model on ``device``, in place of a ``PoseModel`` for
    ``evaluate`` and the predictors.  Quantizes on ``calib_images`` unless
    prebuilt or loaded ``qparams`` are given (the deploy-an-artifact path);
    the MRF tail's weights come from ``state_dict``."""
    device = resolve_device(device)
    if qparams is None:
        qparams = quantize_detector(config, state_dict, calib_images, device=device)
    model = QuantizedPoseModel(config, qparams, make_logits_tail_fn(config, state_dict))
    return model.to(device).eval()


def quantized_model_for(config: Config, state_dict: Mapping, quantize_calib: int = 0,
                        quantize_artifact: str | None = None, train_ds=None,
                        device: str | torch.device | None = None) -> tuple[QuantizedPoseModel, str]:
    """The int8 model that the ``--quantize N`` / ``--quantize-artifact NPZ``
    flags of predict, evaluate and serve ask for, and the line they print:
    the artifact's tensors, or a calibration on the first N images of the
    train split (``train_ds``, made from the config when not given)."""
    device = resolve_device(device)
    if quantize_artifact:
        model = make_quantized_apply_fn(config, state_dict, qparams=load_quantized(quantize_artifact),
                                        device=device)
        return model, f"int8 detector (artifact {quantize_artifact})"
    if train_ds is None:
        from jointpose_torch.data.pipeline import make_dataset

        train_ds = make_dataset(config.data, device)[0]
    calib = train_ds.get_batch(np.arange(min(quantize_calib, train_ds.size)))["image"]
    model = make_quantized_apply_fn(config, state_dict, calib, device=device)
    return model, f"int8 detector (calibrated on {calib.shape[0]} train images)"


def build_quantized_predictor(config: Config, state_dict: Mapping, calib_images=None,
                              qparams: Mapping | None = None,
                              device: str | torch.device | None = None):
    """predict(images) -> (coords, probs) with the int8 detector and the
    float MRF and decode tail, with the flip TTA and decode of
    ``predict.build_predictor``."""
    device = resolve_device(device)
    model = make_quantized_apply_fn(config, state_dict, calib_images, qparams, device)
    return predictor_for(config, model, device)
