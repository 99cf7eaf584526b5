"""Device ms of one chunk through ``generate_image`` of the shifted code,
CUDA events around the benchmark's call, median of 3."""


def read(run):
    return run.readings.get("synthesis_ms")
