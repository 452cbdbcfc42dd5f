"""Share of the traced slice in which the card was idle while the host was
inside the K-step dispatch: the idle gaps that the trace's summary names
after one of the dispatch's spans (``jointpose/dispatch.``: the inputs'
copies, the learning rates, the graph's launch, the outputs), over the
slice, in %: the highest rank's.  None where the program opens no such
span."""

PREFIX = "jointpose/dispatch."


def read(ctx):
    shares = [100.0 * sum(gaps) / t["window_s"] for t in ctx["traces"]
              if (gaps := [s for name, s in t["gaps"].items() if name.startswith(PREFIX)])]
    return max(shares, default=None)
