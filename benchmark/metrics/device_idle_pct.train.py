"""Share of the traced slice in which no kernel, copy or set ran on the
card (the union of their intervals), in %: the highest rank's."""


def read(ctx):
    return max(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in ctx["traces"])
