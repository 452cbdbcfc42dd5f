"""The training steps' share of the cards' bf16 peak: training images x 3
forward FLOPs an image (``harness/work.py``: forward, input and weight
gradients) / (cards x 989 TFLOP/s), over the part of the traced run's
window before its traced slice (the profiler slows the slice itself), in %."""

from benchmark.harness import work


def read(ctx):
    c = ctx["counts"]
    if not c.get("untraced_s"):
        return None
    flops = c["untraced_images"] * work.train_flops_per_image(ctx["config"])
    return 100.0 * flops / c["untraced_s"] / (ctx["chips"] * work.BF16_FLOPS_PER_S)
