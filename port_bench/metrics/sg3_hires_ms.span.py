"""Device ms a chunk of the StyleGAN3 synthesis layers at sampling rate
1024 (L10-L14, where most of the work lies): the device time of the kernels
launched under the program's ``sg3.layer`` spans whose ``rate`` is 1024,
over the traced chunks. None where the program records no such span."""

HIRES = 1024


def read(run):
    calls = run.readings["trace"].under_op("sg3.layer")
    hires = [t for ev, t in calls if (ev.kwinputs or {}).get("rate") == HIRES]
    if not hires:
        return None
    return 1e3 * sum(hires) / run.readings["requests"]
