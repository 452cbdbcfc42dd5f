"""The forward passes' share of the card's bf16 peak: images scored x the
configuration's forward FLOPs an image (``harness/work.py``) / 989
TFLOP/s, over the part of the traced run's window before its traced
slice (the profiler slows the slice itself), in %."""

from benchmark.harness import work


def read(ctx):
    c = ctx["counts"]
    if not c.get("untraced_s"):
        return None
    flops = c["untraced_images"] * work.forward_flops_per_image(ctx["config"])
    return 100.0 * flops / c["untraced_s"] / (ctx["chips"] * work.BF16_FLOPS_PER_S)
