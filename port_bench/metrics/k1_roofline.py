"""K1's share of its roofline over the traced window: the bytes of every
``sdfr::upfirdn2d`` call (input read once, output written once), counted
from its shapes and arguments, against the device time of the kernels
launched inside the calls."""

from harness.work import k1_bytes, roofline_pct


def read(run):
    calls = run.readings["trace"].under_op("sdfr::upfirdn2d")
    calls = [(ev, t) for ev, t in calls if ev.input_shapes]   # the calls whose work is known
    if not calls:
        return None
    item = run.readings.get("itemsize", 4)
    nbytes = 0.0
    for ev, _ in calls:
        _, _, taps_shape, up, pad = ev.concrete_inputs[:5]
        nbytes += k1_bytes(ev.input_shapes[0], taps_shape, up, pad, item)
    return roofline_pct(0.0, nbytes, sum(t for _, t in calls))
