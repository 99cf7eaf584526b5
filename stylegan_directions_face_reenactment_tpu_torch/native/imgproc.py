"""Host image operations and video files.

* :func:`resize_bilinear_u8` and :func:`from_gan_range` are PyTorch on
  CPU tensors, with the arithmetic of the JAX package's native library
  (``reenact_io.cpp``): the resize takes half-pixel centres, clamps at the
  low edge and interpolates in float64; both round half up. The inverse
  conversion is ``pipeline/preprocess.py::to_gan_range``.
* :func:`extract_frames`, :func:`video_fps` and :func:`generate_video` go
  through ``video_io.cpp`` (libav), built with ``g++`` at first use into
  ``build/native/`` beside the package and loaded with ctypes. Where it
  cannot be built (no compiler, no libav headers), every video call raises
  with the compiler's message; there is no other video path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import List, Tuple

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "video_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {  # name: (restype, argtypes)
    "rio_video_open": (_P, [ctypes.c_char_p]),
    "rio_video_width": (_I, [_P]),
    "rio_video_height": (_I, [_P]),
    "rio_video_fps": (ctypes.c_double, [_P]),
    "rio_video_read": (_I, [_P, _P, _I, _I]),
    "rio_video_close": (None, [_P]),
    "rio_writer_open": (_P, [ctypes.c_char_p, _I, _I, _I]),
    "rio_writer_write": (_I, [_P, _P]),
    "rio_writer_close": (_I, [_P]),
}


@functools.lru_cache(maxsize=1)
def video_library() -> ctypes.CDLL:
    """Build ``video_io.cpp`` if its library is not built yet, load it and
    declare its entry points. Raises RuntimeError with g++'s output when
    the build fails, or the loader's when libav's libraries are missing."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"libvideo_io_{digest[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            r = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                               capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the video library needs g++ and libav: {e}") from e
        if r.returncode != 0:
            raise RuntimeError("the video library (libav) did not build:\n"
                               + (r.stdout + r.stderr).strip())
        os.replace(tmp, path)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:   # built where libav was, loaded where it is not
        raise RuntimeError(f"the video library (libav) does not load: {e}") from e
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def extract_frames(path: str, stride: int = 1, max_frames: int = 100_000,
                   get_only_first: bool = False) -> List[np.ndarray]:
    """mp4/avi → HWC uint8 RGB frames, every ``stride``-th
    (``utils_inference.py:35-58``: the reference's ``fps`` argument is a
    stride); ``get_only_first`` returns frame 0 alone."""
    lib = video_library()
    h = lib.rio_video_open(path.encode())
    if not h:
        raise IOError(f"could not open video {path}")
    try:
        width, height = lib.rio_video_width(h), lib.rio_video_height(h)
        limit = 1 if get_only_first else max_frames
        stride = 1 if get_only_first else stride
        frames: List[np.ndarray] = []
        while len(frames) < limit:
            want = min(1 if get_only_first else 64, limit - len(frames))
            buf = np.empty((want, height, width, 3), np.uint8)
            n = lib.rio_video_read(h, buf.ctypes.data_as(ctypes.c_void_p), want, stride)
            frames.extend(buf[i].copy() for i in range(n))
            if n < want:
                break  # the stream is exhausted
        return frames
    finally:
        lib.rio_video_close(h)


def video_fps(path: str) -> float:
    lib = video_library()
    h = lib.rio_video_open(path.encode())
    if not h:
        raise IOError(f"could not open video {path}")
    try:
        return lib.rio_video_fps(h)
    finally:
        lib.rio_video_close(h)


def generate_video(frames: List[np.ndarray], save_path: str, fps: int = 25) -> None:
    """RGB uint8 frames → mp4 (``utils_inference.py:11-18``). The last frame
    is written twice: libav's decoders may swallow an mp4's final sample at
    the end of the stream, so every real frame decodes everywhere and a
    player holds the last image one frame longer."""
    lib = video_library()
    if not frames:
        return
    h, w = frames[0].shape[:2]
    wh = lib.rio_writer_open(save_path.encode(), w, h, fps)
    if not wh:
        raise IOError(f"could not open a video writer for {save_path}")
    try:
        for f in list(frames) + [frames[-1]]:
            f = np.ascontiguousarray(f, np.uint8)
            if f.shape != (h, w, 3):
                raise ValueError(f"frame of shape {f.shape}, expected {(h, w, 3)}")
            if lib.rio_writer_write(wh, f.ctypes.data_as(ctypes.c_void_p)) != 0:
                raise IOError("video encode failed")
    finally:
        lib.rio_writer_close(wh)


def _axis(n_in: int, n_out: int):
    """(low index, high index, weight of the high one) per output
    coordinate, float64: half-pixel centres, clamped at the low edge."""
    f = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    f = f.clamp_min(0.0)
    lo = f.floor()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    return lo.long(), hi.long(), f - lo


def resize_bilinear_u8(batch, out_hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W, 3) uint8 → (N, oh, ow, 3) uint8, bilinear."""
    x = torch.as_tensor(np.ascontiguousarray(batch, np.uint8)).to(torch.float64)
    y0, y1, wy = _axis(x.shape[1], out_hw[0])
    x0, x1, wx = _axis(x.shape[2], out_hw[1])
    wy, wx = wy[:, None, None], wx[:, None]
    top, bot = x[:, y0], x[:, y1]
    v = (1 - wy) * ((1 - wx) * top[:, :, x0] + wx * top[:, :, x1]) \
        + wy * ((1 - wx) * bot[:, :, x0] + wx * bot[:, :, x1])
    return torch.floor(v + 0.5).to(torch.uint8).numpy()


def from_gan_range(batch_f32) -> np.ndarray:
    """float32 in [-1, 1] (an array or a CPU tensor) → uint8, clipped and
    rounded half up."""
    x = torch.as_tensor(batch_f32, dtype=torch.float32)
    return torch.floor(((x + 1.0) * 127.5).clamp(0.0, 255.0) + 0.5).to(torch.uint8).numpy()
