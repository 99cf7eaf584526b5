"""K3's share of its roofline over the traced window: the operations and
bytes of every ``sdfr::fused_conv_block`` call, counted from its input's
shape, against the device time of the kernels launched inside the calls."""

from harness.work import k3_bytes, k3_flops, roofline_pct


def read(run):
    calls = run.readings["trace"].under_op("sdfr::fused_conv_block")
    calls = [(ev, t) for ev, t in calls if ev.input_shapes]   # the calls whose work is known
    if not calls:
        return None
    item = run.readings.get("itemsize", 4)
    flops = sum(k3_flops(ev.input_shapes[0]) for ev, _ in calls)
    nbytes = sum(k3_bytes(ev.input_shapes[0], item) for ev, _ in calls)
    return roofline_pct(flops, nbytes, sum(t for _, t in calls))
