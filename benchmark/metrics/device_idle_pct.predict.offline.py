"""Share of the traced slice in which the card was idle while the host was
inside the predictor: the idle gaps that the trace's summary names after
one of the program's spans (``jointpose/``: the batch's copy to the card,
the detector, the MRF, the decode), over the slice, in %.  None where the
program opens no such span."""

PREFIX = "jointpose/"


def read(ctx):
    t = ctx["traces"][0]
    gaps = [s for name, s in t["gaps"].items() if name.startswith(PREFIX)]
    return 100.0 * sum(gaps) / t["window_s"] if gaps else None
