"""K4's share of its roofline over the traced window: the FIR operations
(polyphase FMAs, counted against the 67 TFLOP/s float32 peak of the CUDA
cores, on which K4 runs its products) and the bytes (input read once,
output written once, against 3.35 TB/s) of every ``sdfr::filtered_lrelu``
call, counted from its recorded shapes and arguments
(``harness/work_k4.py``), against the device time of the kernels launched
inside the calls. None where the program makes no such call."""

from harness.work_k4 import k4_bytes, k4_flops, k4_roofline_pct


def read(run):
    calls = run.readings["trace"].under_op("sdfr::filtered_lrelu")
    calls = [(ev, t) for ev, t in calls if ev.input_shapes]   # the calls whose work is known
    if not calls:
        return None
    item = run.readings.get("itemsize", 4)
    flops = nbytes = 0.0
    for ev, _ in calls:
        _, _, fu, fd, up, down, pad = ev.concrete_inputs[:7]
        shape = ev.input_shapes[0]
        flops += k4_flops(shape, len(fu), len(fd), up, down, pad)
        nbytes += k4_bytes(shape, len(fu), len(fd), up, down, pad, item)
    return k4_roofline_pct(flops, nbytes, sum(t for _, t in calls))
