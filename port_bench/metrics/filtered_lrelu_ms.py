"""Device ms a chunk of K4: the device time of the kernels launched inside
``sdfr::filtered_lrelu`` calls over the traced window, over the traced
chunks. K4's part of the StyleGAN3 synthesis. None where the program makes
no such call."""


def read(run):
    calls = run.readings["trace"].under_op("sdfr::filtered_lrelu")
    if not calls:
        return None
    return 1e3 * sum(t for _, t in calls) / run.readings["requests"]
