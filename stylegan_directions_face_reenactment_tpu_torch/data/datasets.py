"""VoxCeleb-layout datasets on the host (the reference's
``libs/datasets/dataloader.py``, ``dataloader_paired.py`` and
``dataloader_inversion.py``; the JAX package's ``data/datasets.py``).
Layout (reference README):

    dataset_path/<id>/<video>/frames_cropped/*.png
    dataset_path/<id>/<video>/inversion/frames/*.png
    dataset_path/<id>/<video>/inversion/latent_codes/*.npy

Samples are numpy NHWC float32 in [-1, 1] (the reference's resize(256) →
ToTensor → Normalize(.5, .5, .5)). Every random choice is numpy's
``RandomState``, drawn in the JAX package's order, so one seed gives the
same samples in both packages.
"""

from __future__ import annotations

import glob
import os
import queue as queue_mod
import threading
from typing import Any, Dict, Iterator, List, Optional

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


def _inversion_dir(video_path: str) -> str:
    inv_dir = os.path.join(video_path, "inversion")
    if not os.path.exists(inv_dir):
        raise FileNotFoundError(f"Path with inverted latent codes does not exist: {inv_dir}")
    return inv_dir


def _load_code(path: str) -> np.ndarray:
    code = np.load(path).astype(np.float32)
    if code.ndim != 2:
        raise ValueError(f"latent code should be L x 512, got {code.shape} in {path}")
    return code


class CustomDataset:
    """Per-frame {real_img, inv_img, w, path} samples (``dataloader.py:19-126``);
    ``path`` keys the Trainer's coefficient cache."""

    def __init__(self, dataset_path: str, image_size: int = 256):
        self.dataset_path = dataset_path
        self.image_size = image_size
        real, inv, w = [], [], []
        counter_ids = counter_videos = 0
        for id_path in _list_ids(dataset_path):
            counter_ids += 1
            for video_path in _video_paths(id_path):
                inv_dir = _inversion_dir(video_path)
                real += sorted(glob.glob(os.path.join(video_path, "frames_cropped", "*.png")))
                inv += sorted(glob.glob(os.path.join(inv_dir, "frames", "*.png")))
                w += sorted(glob.glob(os.path.join(inv_dir, "latent_codes", "*.npy")))
                counter_videos += 1
        self.real_images = np.asarray(real)
        self.inv_images = np.asarray(inv)
        self.w = np.asarray(w)
        self.counter_ids = counter_ids
        self.counter_videos = counter_videos

    def get_length(self):
        return len(self.real_images), self.counter_ids, self.counter_videos

    def __len__(self):
        return len(self.real_images)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return {"real_img": load_image_gan_range(self.real_images[index], self.image_size),
                "inv_img": load_image_gan_range(self.inv_images[index], self.image_size),
                "w": _load_code(self.w[index]),
                "path": str(self.real_images[index])}


class CustomDatasetTestsetSynthetic:
    """Fixed random z pairs for the synthetic evaluation
    (``dataloader.py:128-174``): from a ``.npy`` of 2·num_samples codes, or
    drawn from ``seed`` (and saved under ``save_dir`` when given)."""

    def __init__(self, synthetic_dataset_path: Optional[str] = None,
                 num_samples: int = 100, save_dir: Optional[str] = None, seed: int = 0):
        self.num_samples = num_samples
        if synthetic_dataset_path is not None:
            z = np.load(synthetic_dataset_path).astype(np.float32)
            self.fixed_source_w = z[:num_samples]
            self.fixed_target_w = z[num_samples:2 * num_samples]
        else:
            rng = np.random.RandomState(seed)
            self.fixed_source_w = rng.randn(num_samples, 512).astype(np.float32)
            self.fixed_target_w = rng.randn(num_samples, 512).astype(np.float32)
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                np.save(os.path.join(save_dir, f"random_latent_codes_{2 * num_samples}.npy"),
                        np.concatenate([self.fixed_source_w, self.fixed_target_w]))

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int):
        return {"source_w": self.fixed_source_w[index],
                "target_w": self.fixed_target_w[index]}


class CustomDatasetTestsetReal:
    """Inverted real W+ sources with random z targets
    (``dataloader.py:176-258``)."""

    def __init__(self, dataset_path: str, num_samples: int = 100, shuffle: bool = True,
                 seed: int = 0):
        w = []
        for id_path in _list_ids(dataset_path):
            for video_path in _video_paths(id_path):
                w += sorted(glob.glob(os.path.join(_inversion_dir(video_path),
                                                   "latent_codes", "*.npy")))
        w = np.asarray(w)
        rng = np.random.RandomState(seed)
        if shuffle:
            w = w[rng.permutation(len(w))]
        self.w = w[:num_samples]
        self.num_samples = min(num_samples, len(w))
        self.fixed_target_w = rng.randn(self.num_samples, 512).astype(np.float32)

    def get_length(self):
        return self.num_samples

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int):
        return {"source_w": _load_code(self.w[index]),
                "target_w": self.fixed_target_w[index]}


class CustomDatasetPaired:
    """Source/target frame pairs of one video: ``max_pairs`` source frames a
    video, each with a random other frame as its target; :meth:`resample`
    re-shuffles and re-picks them (each epoch, ``dataloader_paired.py:14-148``,
    ``trainer.py:398-404``)."""

    def __init__(self, dataset_path: str, num_samples: Optional[int] = None,
                 max_pairs: int = 2, seed: Optional[int] = None, image_size: int = 256):
        self.dataset_path = dataset_path
        self.max_pairs = max_pairs
        self.image_size = image_size
        self.rng = np.random.RandomState(seed)
        self.resample()

    def resample(self):
        """Re-shuffle each video's frame order and re-pick the source frames."""
        self.videos: Dict[Any, Dict[str, Any]] = {}
        self.samples: List[Any] = []
        counter_ids = counter_videos = 0
        for id_path in _list_ids(self.dataset_path):
            id_index = id_path.rstrip("/").split("/")[-1]
            counter_ids += 1
            for video_path in _video_paths(id_path):
                video_id = video_path.rstrip("/").split("/")[-1]
                frames = sorted(glob.glob(os.path.join(video_path, "frames_cropped",
                                                       "*.png")))
                codes = sorted(glob.glob(os.path.join(_inversion_dir(video_path),
                                                      "latent_codes", "*.npy")))
                if frames and codes:
                    perm = self.rng.permutation(len(frames))
                    key = (id_index, video_id)
                    self.videos[key] = {"frames": np.asarray(frames)[perm],
                                        "codes": np.asarray(codes)[perm],
                                        "num_frames": len(frames)}
                    if len(frames) >= 2:
                        for j in range(min(self.max_pairs, len(frames))):
                            self.samples.append((key, j))
                        counter_videos += 1
        self.counter_ids = counter_ids
        self.counter_videos = counter_videos
        self.num_samples = len(self.samples)

    def get_length(self):
        return self.num_samples, self.counter_ids, self.counter_videos

    def __len__(self):
        return self.num_samples

    def _sample(self, video, source_index: int, target_index: int) -> Dict[str, Any]:
        def code(i):
            return np.load(video["codes"][i]).astype(np.float32).reshape(-1, 512)
        return {"source_img": load_image_gan_range(video["frames"][source_index],
                                                   self.image_size),
                "source_latent_code": code(source_index),
                "target_img": load_image_gan_range(video["frames"][target_index],
                                                   self.image_size),
                "target_latent_code": code(target_index)}

    def __getitem__(self, index: int):
        key, source_index = self.samples[index]
        video = self.videos[key]
        target_index = source_index
        while target_index == source_index:
            target_index = int(self.rng.randint(video["num_frames"]))
        return {**self._sample(video, source_index, target_index),
                # frame identities for the Trainer's coefficient cache
                "source_path": str(video["frames"][source_index]),
                "target_path": str(video["frames"][target_index])}


class CustomDatasetPairedValidation(CustomDatasetPaired):
    """Pairs with a target fixed per sample (``dataloader_paired.py:151-275``)."""

    def __init__(self, dataset_path: str, num_samples: Optional[int] = None,
                 max_pairs: int = 2, seed: int = 0, image_size: int = 256):
        super().__init__(dataset_path, num_samples, max_pairs, seed=seed,
                         image_size=image_size)
        self.fixed_targets = {}
        for i, (key, src) in enumerate(self.samples):
            n = self.videos[key]["num_frames"]
            t = src
            while t == src:
                t = int(self.rng.randint(n))
            self.fixed_targets[i] = t
        if num_samples is not None:
            self.num_samples = min(num_samples, self.num_samples)

    def __getitem__(self, index: int):
        key, source_index = self.samples[index]
        return self._sample(self.videos[key], source_index, self.fixed_targets[index])


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
