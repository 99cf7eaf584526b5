"""The port's video files (``native/imgproc.py``: OpenCV's ``VideoCapture``
and ``VideoWriter`` with fourcc ``mp4v``, as the reference) against the JAX
package's libav library (``native/imgproc.py`` there), and the errors of
the port's three video functions.

Frames: 40 smooth 64×96 RGB frames made with numpy. Tolerances: each
writer's file decodes to the same frame count and rate through both
readers, and the two readers' frames are equal (both decode with FFmpeg's
decoders; read 0 difference on this dev box); every decoded frame is
within a mean of 6 intensity units of the frame written (lossy codecs;
read 4.4 and 4.5). The libav cases skip where the JAX package's native
library is not built.
"""

import sys

import numpy as np
import pytest

from stylegan_directions_face_reenactment_tpu.native import imgproc as j_imgproc

from stylegan_directions_face_reenactment_tpu_torch.native import imgproc
from torch_threads import _threads  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    yy, xx = np.mgrid[:64, :96]
    return [np.stack([(xx * 2 + 5 * i) % 256, yy * 3, (xx + yy + 7 * i) % 256],
                     -1).astype(np.uint8) for i in range(40)]


READERS = {"cv2": imgproc, "libav": j_imgproc}


@pytest.mark.parametrize("writer", ["cv2", "libav"])
def test_backends_agree(tmp_path, frames, writer):
    """The port (cv2) or the JAX package (libav) writes; both read back the
    same frames at the same rate, and those are the frames written within
    the codec's loss. Each writer adds the last frame once more, which
    libav's decoder may swallow from its own files."""
    if not j_imgproc.native_available():
        pytest.skip("the JAX package's native video library is not built here")
    path = str(tmp_path / f"{writer}.mp4")
    READERS[writer].generate_video(frames, path, fps=25)
    back = {b: m.extract_frames(path) for b, m in READERS.items()}
    assert len(back["libav"]) == len(back["cv2"]) in (len(frames), len(frames) + 1)
    for a, c in zip(back["libav"], back["cv2"]):
        assert a.shape == c.shape == (64, 96, 3)
        np.testing.assert_array_equal(a, c)
    for got, want in zip(back["cv2"], frames + frames[-1:]):
        assert np.abs(got.astype(int) - want.astype(int)).mean() < 6
    fps = {b: m.video_fps(path) for b, m in READERS.items()}
    assert abs(fps["libav"] - 25.0) <= 1.0 and abs(fps["cv2"] - 25.0) <= 1.0
    for b, m in READERS.items():
        every2 = m.extract_frames(path, stride=2)
        assert len(every2) == (len(back[b]) + 1) // 2
        np.testing.assert_array_equal(every2[1], back[b][2])
        first = m.extract_frames(path, get_only_first=True)
        assert len(first) == 1
        np.testing.assert_array_equal(first[0], back[b][0])


def test_cv2_round_trip(tmp_path, frames):
    """The port alone, where libav need not be there: 41 frames (the last
    twice), RGB kept (not swapped to BGR), rate 25, ``max_frames``."""
    path = str(tmp_path / "v.mp4")
    imgproc.generate_video(frames, path, fps=25)
    back = imgproc.extract_frames(path)
    assert len(back) == len(frames) + 1
    assert imgproc.video_fps(path) == 25.0
    for got, want in zip(back, frames + frames[-1:]):
        assert np.abs(got.astype(int) - want.astype(int)).mean() < 6
    swapped = np.abs(back[0].astype(int) - frames[0][..., ::-1].astype(int)).mean()
    assert swapped > 20
    assert len(imgproc.extract_frames(path, max_frames=7)) == 7


@pytest.mark.parametrize("case", ["read_missing", "fps_missing", "writer_unopenable",
                                  "frame_shape", "no_frames"])
def test_video_errors(tmp_path, frames, case):
    """A missing file cannot be read (IOError), a file that cannot be
    created cannot be written (IOError), frames of two shapes are refused
    before anything is written (ValueError), and no frames write nothing."""
    path = str(tmp_path / "v.mp4")
    if case == "read_missing":
        with pytest.raises(IOError, match="could not open video"):
            imgproc.extract_frames(path)
    elif case == "fps_missing":
        with pytest.raises(IOError, match="could not open video"):
            imgproc.video_fps(path)
    elif case == "writer_unopenable":
        with pytest.raises(IOError, match="could not open a video writer"):
            imgproc.generate_video(frames[:3], str(tmp_path / "absent" / "v.mp4"))
    elif case == "frame_shape":
        with pytest.raises(ValueError, match="frame of shape"):
            imgproc.generate_video([frames[0], frames[1][:32]], path)
    else:
        imgproc.generate_video([], path)
    assert not (tmp_path / "v.mp4").exists()


def test_run_inference_needs_cv2_first(tmp_path, monkeypatch):
    """``run_inference.main`` with ``--save_video`` (its default) stops on a
    missing OpenCV before it makes its output directory or loads a model."""
    from stylegan_directions_face_reenactment_tpu_torch.cli import run_inference
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = tmp_path / "out"
    with pytest.raises(ImportError):
        run_inference.main(["--source_path", str(tmp_path / "s.png"), "--target_path",
                            str(tmp_path / "t.mp4"), "--output_path", str(out),
                            "--device", "cpu"])
    assert not out.exists()
