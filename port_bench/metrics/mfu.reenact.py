"""The whole request's share of the TF32 dense peak: the reference's
matrix and convolution FLOPs of one request (``FlopCounterMode``, forward
and any backward), times the requests completed in the traced window,
over the window's seconds."""

from harness.work import mfu_pct


def read(run):
    flops = run.readings.get("flops_per_request")
    if flops is None:
        return None
    tr = run.readings["trace"]
    return mfu_pct(flops * run.readings["requests"], tr.window_s)
