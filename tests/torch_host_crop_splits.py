"""Host times of the FFHQ crop of in-frame boxes: one loop running torch on
every core (``native/imgproc.py::ffhq_crop_batch``) against the same frames
split over worker threads, each running torch on its share of the cores,
as the JAX package's native library spreads them over threads. Not a test,
and it needs no card: run it from the repo's root,

    PYTHONPATH=. python tests/torch_host_crop_splits.py

It prints, for 16 frames of 562×1000 (uniform noise from numpy seed 43,
landmarks on a ring inside each frame, as ``chip_smoke.py``'s [cli] host
crop plants them), the median, min and max ms of 5 calls of each split,
workers × torch threads, and whether each split gives the loop's bytes.
glibc's allocator moves these times; prefix
``MALLOC_MMAP_THRESHOLD_=1073741824 MALLOC_TRIM_THRESHOLD_=1073741824`` to
keep the crops' buffers off freshly mapped pages.
"""

import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from stylegan_directions_face_reenactment_tpu_torch.models.face.cropping import (
    ffhq_box, resample_u8)
from stylegan_directions_face_reenactment_tpu_torch.native.imgproc import ffhq_crop_batch

FRAMES, HEIGHT, WIDTH, REPS = 16, 562, 1000, 5


def inputs():
    rs = np.random.RandomState(43)
    frames = rs.randint(0, 256, (FRAMES, HEIGHT, WIDTH, 3)).astype(np.uint8)
    t = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    pts = []
    for _ in range(FRAMES):
        cx, cy, r = rs.uniform(250, 750), rs.uniform(250, 320), rs.uniform(50, 100)
        k = rs.uniform(0.6, 1.0, (2, 68))
        pts.append(np.stack([cx + r * np.cos(t) * k[0], cy + r * np.sin(t) * k[1]], -1))
    return frames, np.float32(pts)


def split(frames, pts, workers, threads):
    """The frames over ``workers`` threads, each running torch on ``threads``."""
    crops = np.zeros((len(frames), 256, 256, 3), np.uint8)

    def crop(i):
        x1, y1, x2, y2 = ffhq_box(pts[i])
        crops[i] = resample_u8(frames[i, y1:y2, x1:x2], (256, 256))

    with ThreadPoolExecutor(workers, initializer=torch.set_num_threads,
                            initargs=(threads,)) as pool:
        list(pool.map(crop, range(len(frames))))
    return crops


def timed(fn):
    out = fn()
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(runs), min(runs), max(runs)


def main():
    frames, pts = inputs()
    cores = torch.get_num_threads()
    env = {k: v for k, v in os.environ.items() if k.startswith("MALLOC_")}
    print(f"{FRAMES} in-frame frames of {HEIGHT}x{WIDTH}, {os.cpu_count()} host cores, "
          f"torch {torch.__version__} on {cores} intra-op threads, allocator settings {env}")
    (want, done), med, lo, hi = timed(lambda: ffhq_crop_batch(frames, pts))
    assert done.all()
    print(f"  loop (ffhq_crop_batch), 1 x {cores}: {med:.3f} ms (min {lo:.3f}, max {hi:.3f})")
    for workers in (1, 2, 4, 8):
        threads = max(1, cores // workers)
        try:
            got, med, lo, hi = timed(lambda: split(frames, pts, workers, threads))
        finally:
            torch.set_num_threads(cores)
        print(f"  threads, {workers} x {threads}: {med:.3f} ms (min {lo:.3f}, max {hi:.3f}); "
              f"{int((got != want).sum())} bytes differ from the loop's")


if __name__ == "__main__":
    main()
