"""Share of the traced slice in which no kernel, copy or set ran on the
card (the union of their intervals), in %."""


def read(ctx):
    t = ctx["traces"][0]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
