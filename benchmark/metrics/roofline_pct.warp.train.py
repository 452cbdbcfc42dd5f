"""Row 4, the fused shear warp (``csrc/shear_warp.cu``,
``shear_warp_fused``), against its bound: launches x the bound of one
step's rows (``harness/work.warp_bound_s``) over their device time, over
all ranks, in %.  None without a launch."""

from benchmark.harness import work

KERNEL = "shear_warp_fused_kernel"


def read(ctx):
    rows = ctx["traffic"]["rows_per_rank"]
    bound = spent = 0.0
    for t in ctx["traces"]:
        for name, (count, seconds) in t["ops"].items():
            if KERNEL in name:
                spent += seconds
                bound += count * work.warp_bound_s(ctx["config"], rows)
    return 100.0 * bound / spent if spent > 0 else None
