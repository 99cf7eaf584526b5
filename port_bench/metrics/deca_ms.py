"""Device ms of one chunk through ``calculate_shapemodel`` with
``align_for(fan, sfd)`` (SFD + FAN alignment and DECA's encoder), CUDA
events around the benchmark's call, median of 3."""


def read(run):
    return run.readings.get("deca_ms")
