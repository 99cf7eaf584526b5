"""Device ms a chunk of the program's own ``reenact.preprocess`` span inside
the timed entry (SFD → FAN → FFHQ crop of the raw frames): the device time
of the kernels launched under it, median over the traced chunks. None
where the program records no such span."""

from statistics import median


def read(run):
    calls = run.readings["trace"].under_op("reenact.preprocess")
    return 1e3 * median(t for _, t in calls) if calls else None
