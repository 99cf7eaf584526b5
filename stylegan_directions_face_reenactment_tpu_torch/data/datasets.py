"""VoxCeleb-layout datasets on the host (the reference's
``libs/datasets/dataloader_inversion.py``; the JAX package's
``data/datasets.py``). Layout (reference README):

    dataset_path/<id>/<video>/frames_cropped/*.png
    dataset_path/<id>/<video>/inversion/frames/*.png
    dataset_path/<id>/<video>/inversion/latent_codes/*.npy

Samples are numpy NHWC float32 in [-1, 1] (the reference's resize(256) →
ToTensor → Normalize(.5, .5, .5)). The training datasets wait for the
training slice.
"""

from __future__ import annotations

import glob
import os
import queue as queue_mod
import threading
from typing import Any, Dict, Iterator, List

import numpy as np


def load_image_gan_range(path: str, size: int = 256) -> np.ndarray:
    """An image file → (size, size, 3) float32 in [-1, 1], resized with
    Pillow's bilinear filter where its size differs."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def _list_ids(dataset_path: str) -> List[str]:
    ids = sorted(glob.glob(os.path.join(dataset_path, "*/")))
    if not ids:
        raise FileNotFoundError(f"Dataset has no identities in path {dataset_path}")
    return ids


def _video_paths(id_path: str) -> List[str]:
    return sorted(glob.glob(os.path.join(id_path, "*/")))


class DatasetInversion:
    """Every ``frames_cropped`` PNG of the tree, in sorted order, with its
    identity, video and file name (``dataloader_inversion.py:10-123``)."""

    def __init__(self, dataset_path: str, image_size: int = 256):
        self.image_size = image_size
        self.entries: List[Dict[str, str]] = []
        for id_path in _list_ids(dataset_path):
            id_index = id_path.rstrip("/").split("/")[-1]
            for video_path in _video_paths(id_path):
                video_id = video_path.rstrip("/").split("/")[-1]
                for f in sorted(glob.glob(os.path.join(video_path, "frames_cropped",
                                                       "*.png"))):
                    self.entries.append({
                        "path": f, "id_index": id_index, "video_index": video_id,
                        "filename": os.path.splitext(os.path.basename(f))[0]})

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index: int):
        e = self.entries[index]
        return {"image": load_image_gan_range(e["path"], self.image_size), **e}


class Loader:
    """Batches of a dataset, stacked where a field is an array and listed
    otherwise, made by a background thread ``prefetch`` batches ahead (the
    reference's DataLoader with one worker, ``trainer.py:225-229``); the
    order is shuffled by ``np.random.RandomState(seed)``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def _collate(self, samples):
        out: Dict[str, Any] = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            for batch_idx in self._index_batches():
                q.put(self._collate([self.dataset[int(i)] for i in batch_idx]))
            q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
