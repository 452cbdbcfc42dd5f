"""Row 3, the fused Fourier MRF tail at 3xTF32 (``csrc/mrf_fft_tail.cu``,
``ops/mrf_fft_fused.fused_tail`` at precision 'high'), against its bound in
a training cell: launches x the bound of one call at a step's rows a rank
over their device time (the tail's kernel and, where a call splits a tile's
source joints over blocks, its combine kernel), over all ranks, in %.  None
without a launch.

One call's bound: the tail's bytes (``harness/work.mrf_tail_bound_s``'s:
the spectra, the inverse tables and the biases read once, the fp32 output
written once) at HBM's rate, or three times its products (3xTF32) at the
TF32 tensor-core peak, whichever is longer."""

from benchmark.harness import work

KERNEL = "mrf_fft_tail_kernel<3>"
COMBINE = "mrf_fft_tail_combine_kernel"
JOINTS = 9


def call_bound_s(cfg: dict, rows: int) -> float:
    h = cfg["data"]["image_hw"][0] // cfg["data"]["heatmap_stride"]
    w = cfg["data"]["image_hw"][1] // cfg["data"]["heatmap_stride"]
    wh, ww = cfg["mrf"]["window"]
    k = JOINTS
    ph, g = h + wh - 1, (w + ww - 1) // 2 + 1
    per_pair = 6 * ph * g + 8 * h * ph * g + 4 * h * g * w + 4 * h * w
    n_bytes = 4 * (2 * rows * k * ph * g + 2 * k * k * ph * g + h * ph * 2 + 2 * g * w + k * k
                   + rows * k * h * w)
    return max(n_bytes / work.HBM_BYTES_PER_S, 3 * rows * k * k * per_pair / work.TF32_FLOPS_PER_S)


def read(ctx):
    bound = spent = 0.0
    for t in ctx["traces"]:
        for name, (count, seconds) in t["ops"].items():
            if KERNEL in name:
                spent += seconds
                bound += count * call_bound_s(ctx["config"], ctx["traffic"]["rows_per_rank"])
            elif COMBINE in name:
                spent += seconds
    return 100.0 * bound / spent if bound > 0 else None
