"""Device ms of one chunk through ``preprocess_batch_device`` (SFD → FAN →
FFHQ crop), CUDA events around the benchmark's call, median of 3."""


def read(run):
    return run.readings.get("preprocess_ms")
