"""The MRF's grouped correlation (``csrc/mrf_grouped_corr.cu``, the forward of
``ops/mrf_xla.grouped_conv_f32``) against its bound in the training cell:
launches x the bound of one call at a step's rows a rank over their device
time, over all ranks, in %.  None without a launch.

One call's bound: its products at the bf16 tensor-core peak, or its bytes
(p in bf16 read, the kernels in bf16 read, the fp32 responses written, each
once) at HBM's rate, whichever is longer, on the coarse grid of the
configuration (the heatmap pooled by the MRF's stride), 9 joints."""

from benchmark.harness import work

KERNEL = "mrf_grouped_corr"
JOINTS = 9


def call_bound_s(cfg: dict, rows: int) -> float:
    stride = cfg["data"]["heatmap_stride"] * cfg["mrf"]["stride"]
    pixels = rows * (cfg["data"]["image_hw"][0] // stride) * (cfg["data"]["image_hw"][1] // stride)
    taps = cfg["mrf"]["window"][0] * cfg["mrf"]["window"][1]
    n_bytes = 2 * pixels * JOINTS + 2 * taps * JOINTS ** 2 + 4 * pixels * JOINTS ** 2
    return work.bound_s(n_bytes, 2 * pixels * JOINTS ** 2 * taps, work.BF16_FLOPS_PER_S)


def read(ctx):
    bound = spent = 0.0
    for t in ctx["traces"]:
        for name, (count, seconds) in t["ops"].items():
            if KERNEL in name:
                spent += seconds
                bound += count * call_bound_s(ctx["config"], ctx["traffic"]["rows_per_rank"])
    return 100.0 * bound / spent if spent > 0 else None
