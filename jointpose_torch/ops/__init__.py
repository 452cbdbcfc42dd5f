"""Heatmap maths, the MRF message passes, the augmentation warp and the
Fourier head conv, with the wrappers of the CUDA kernels under ``csrc/``."""


def launch_counters() -> list[tuple[object, str]]:
    """Every kernel wrapper's launch counter, as (holder, attribute): what a
    captured CUDA graph adds to on each replay (``graphs.Graph``),
    so that a counter keeps meaning launches that reached the card.  The
    fused Fourier pass's count of backward recomputes is one of them."""
    from jointpose_torch.ops import (
        fft_conv, mrf_corr, mrf_epilogue, mrf_fft_fused, mrf_upsample, warp,
    )

    return [
        (mrf_epilogue.mrf_epilogue, "launches"), (mrf_epilogue.mrf_epilogue_bwd, "launches"),
        (mrf_fft_fused.fused_tail, "launches"), (mrf_fft_fused.fused_tail, "launches_1pass"),
        (mrf_fft_fused._FusedPass, "recomputes"),
        (warp.shear_warp, "launches"), (warp.shear_warp_rowmajor, "launches"),
        (fft_conv.tail_kdft_resident, "launches"), (fft_conv.tail_kdft, "launches"),
        (fft_conv.tail_kf, "launches"),
        (mrf_corr.mrf_grouped_corr, "launches"),
        (mrf_upsample.mrf_upsample_log, "launches"),
        (mrf_upsample.mrf_upsample_log_bwd, "launches"),
    ]
