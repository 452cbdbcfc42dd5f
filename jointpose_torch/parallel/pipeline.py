"""Two-stage inference pipeline: detector | MRF + decode (counterpart of
``jointpose/parallel/pipeline.py``).

The pose model splits at its natural seam onto two device groups:

- stage 0 runs the detector on each microbatch (the int8 detector of
  ``ops/quant.py`` when ``qparams`` are given), split over its devices;
- the (B, Hm, Wm, K) logits hop to stage 1's devices;
- stage 1 runs the MRF tail, the spatial softmax and the decode
  (``models/pose.make_logits_tail_fn``), split over its devices.

One process drives both groups.  Each stage device has a CUDA stream of
its own and the hop is a non-blocking ``.to()`` ordered by events, so
stage 0 of microbatch i+1 overlaps stage 1 of microbatch i.  A device
list may repeat a device: ``["cuda:0", "cuda:0"]`` runs both groups on
one card on two streams (the schedule only), ``["cpu", "cpu"]`` runs it
on the CPU, in order.  Flip TTA composes as in the reference: stage 0
emits the logits of both orientations, stage 1 unflips and averages the
probabilities like ``predict.build_predictor``.

The DFT tables that the Fourier head and the Fourier MRF cache per
geometry and device are built on the default stream by one warm-up
forward of each stage before the streams split, so no stage reads a
table another stream is still writing.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch

from jointpose_torch.configs import Config
from jointpose_torch.models.pose import PoseModel, make_logits_tail_fn
from jointpose_torch.ops.heatmaps import decode_probs, model_probs


def default_stage_devices() -> list[torch.device]:
    """Every card of the process; the one card twice where there is one."""
    from jointpose_torch.predict import resolve_device

    resolve_device(None)  # raises without CUDA
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return cards if len(cards) > 1 else cards * 2


def split_stage_devices(devices: Sequence | None = None) -> tuple[list, list]:
    """Split a device list into the two stage groups (the detector-heavy
    stage 0 gets the extra device when the count is odd)."""
    devices = [torch.device(d) for d in (default_stage_devices() if devices is None else devices)]
    if len(devices) < 2:
        raise ValueError(f"pipeline parallelism needs >= 2 devices, have {len(devices)}")
    cut = (len(devices) + 1) // 2
    return devices[:cut], devices[cut:]


class _Stream:
    """A device's side stream, or nothing on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __enter__(self):
        if self.stream is not None:
            self._ctx = torch.cuda.stream(self.stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self.stream is not None:
            self._ctx.__exit__(*exc)

    def event(self):
        """An event recorded on this stream now (None on the CPU)."""
        return None if self.stream is None else self.stream.record_event()

    def wait(self, event) -> None:
        if self.stream is not None and event is not None:
            self.stream.wait_event(event)

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        """Mark ``t``, made on another stream, as used on this one."""
        if self.stream is not None and t.device.type == "cuda":
            t.record_stream(self.stream)
        return t


def build_pipelined_predictor(
    config: Config, state_dict: Mapping[str, torch.Tensor], devices: Sequence | None = None,
    n_micro: int = 2, qparams: Mapping | None = None,
):
    """Return predict(images) -> (coords, probs) running the two stages over
    ``devices`` (default: ``default_stage_devices``), microbatched
    ``n_micro`` ways.

    Semantics match ``predict.build_predictor`` (the same normalization,
    decode and flip TTA); only the schedule differs.  The batch must divide
    by ``n_micro``, and each microbatch by each stage's device count.  The
    outputs lie on stage 1's first device.  ``head_conv_impl='auto'``
    needs no pinning here: the port resolves it by a rule on the config
    alone (``models/detector.resolve_head_conv_impl``), not on the batch.
    """
    from jointpose_torch.evaluate import flip_images, unflip_heatmaps

    g0, g1 = split_stage_devices(devices)
    cfg = config
    stride = cfg.data.heatmap_stride
    tta = cfg.eval_flip_tta
    models: dict[torch.device, PoseModel] = {}
    for dev in dict.fromkeys(g0 + g1):
        model = PoseModel(cfg)
        model.load_state_dict(state_dict)
        models[dev] = model.to(dev).eval()
    q_on: dict[torch.device, dict] = {}
    if qparams is not None:
        from jointpose_torch.ops.quant import quant_detector_logits

        q_on = {dev: {n: {f: t.to(dev) for f, t in node.items()} for n, node in qparams.items()}
                for dev in dict.fromkeys(g0)}

    def det_logits(dev: torch.device, images: torch.Tensor) -> torch.Tensor:
        if qparams is not None:
            return quant_detector_logits(cfg, q_on[dev], images)
        return models[dev](images, detector_only=True)["detector_logits"]

    def stage0(dev: torch.device, images: torch.Tensor) -> list[torch.Tensor]:
        logits = [det_logits(dev, images)]
        if tta:
            logits.append(det_logits(dev, flip_images(images)))
        return logits

    tails = {dev: make_logits_tail_fn(cfg, models[dev]) for dev in dict.fromkeys(g1)}

    def stage1(dev: torch.device, logits: list[torch.Tensor]):
        probs = model_probs(tails[dev](logits[0]))
        if tta:
            probs = 0.5 * (probs + unflip_heatmaps(model_probs(tails[dev](logits[1]))))
        return decode_probs(probs, stride, refine=cfg.decode_refine), probs

    streams0 = {dev: _Stream(dev) for dev in dict.fromkeys(g0)}
    streams1 = {dev: _Stream(dev) for dev in dict.fromkeys(g1)}
    out_dev = g1[0]

    # Warm-up on the default streams: the cached DFT tables and the kernel
    # builds come into being before the side streams read them.
    with torch.inference_mode():
        h, w = cfg.data.image_hw
        for dev in dict.fromkeys(g0):
            warm = stage0(dev, torch.zeros(1, h, w, 3, dtype=torch.uint8, device=dev))
        for dev in dict.fromkeys(g1):
            stage1(dev, [x.to(dev) for x in warm])
    for dev in dict.fromkeys(g0 + g1):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        b = images.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} must divide into {n_micro} microbatches")
        mb = b // n_micro
        if mb % len(g0) or mb % len(g1):
            raise ValueError(
                f"microbatch {mb} must divide stage device counts ({len(g0)}, {len(g1)})")
        r0, r1 = mb // len(g0), mb // len(g1)
        callers = [torch.cuda.current_stream(d) for d in dict.fromkeys((images.device, out_dev))
                   if d.type == "cuda"]
        if images.device.type == "cuda":
            ready = callers[0].record_event()
            for s in streams0.values():
                s.wait(ready)
        outs = []
        for i in range(n_micro):
            parts = []  # stage 0: (rows' logits, the event that they are done), per device
            for k, dev in enumerate(g0):
                s = streams0[dev]
                lo = i * mb + k * r0
                with s:
                    logits = stage0(dev, images[lo:lo + r0].to(dev, non_blocking=True))
                    parts.append((logits, s.event()))
            for j, dev in enumerate(g1):
                s = streams1[dev]
                with s:
                    pieces = []
                    for k, (logits, done) in enumerate(parts):
                        lo, hi = max(j * r1, k * r0), min((j + 1) * r1, (k + 1) * r0)
                        if lo >= hi:
                            continue
                        s.wait(done)
                        # The hop, ordered after stage 0's event.  A copy from
                        # another card: stage 0's stream (whose memory it reads)
                        # waits for it before reusing that memory.
                        xs = [x[lo - k * r0:hi - k * r0] for x in logits]
                        if g0[k] == dev:
                            pieces.append([s.keep(x) for x in xs])
                        else:
                            pieces.append([x.to(dev, non_blocking=True) for x in xs])
                            streams0[g0[k]].wait(s.event())
                    logits = [torch.cat(xs) for xs in zip(*pieces)]
                    outs.append(stage1(dev, logits))
        # The caller's streams go on after every stage stream, and the stage
        # streams reuse nothing the gather below still reads.
        finals = [s.event() for s in (*streams0.values(), *streams1.values())]
        for cs in callers:
            for e in finals:
                cs.wait_event(e)
        coords = torch.cat([_on(c, out_dev) for c, _ in outs])
        probs = torch.cat([_on(p, out_dev) for _, p in outs])
        if out_dev.type == "cuda":
            gathered = torch.cuda.current_stream(out_dev).record_event()
            for s in streams1.values():
                s.wait(gathered)
        return coords, probs

    return predict


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, marked as used by that device's current stream."""
    if t.device.type == "cuda" and t.device == device:
        t.record_stream(torch.cuda.current_stream(device))
    return t.to(device)
