"""Camera dataset + infinite shuffling prefetch loader (port of
`tpu_splat/training/dataset.py`). The prefetch threads decode into numpy arrays and never
touch a CUDA tensor; the trainer moves each sample to the card.

Reference: src/training/dataset.hpp — TRAIN/VAL/ALL split by `test_every` modulo
(dataset.hpp:40-49), lazy per-batch image loads on worker threads (:64-74),
InfiniteRandomSampler (:116-135), torch DataLoader with num_workers prefetch (:247-259).
Here: a thread-pool prefetcher decoding JPEGs ahead of the train loop; batch size 1
(one camera per step, like the reference).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..core.camera import Camera
from ..io.image import load_image


@dataclass
class CameraSample:
    camera: Camera
    image: np.ndarray  # [3,H,W] float32
    fx: float
    fy: float
    cx: float
    cy: float
    index: int = 0  # position within this dataset's split (poseopt/bilateral id)


def split_cameras(cameras: list[Camera], test_every: int, split: str) -> list[Camera]:
    """TRAIN = idx % test_every != 0, VAL = idx % test_every == 0 (dataset.hpp:40-49)."""
    if split == "all" or test_every <= 0:
        return list(cameras)
    if split == "train":
        return [c for i, c in enumerate(cameras) if i % test_every != 0]
    if split == "val":
        return [c for i, c in enumerate(cameras) if i % test_every == 0]
    raise ValueError(split)


class CameraDataset:
    def __init__(self, cameras: list[Camera], resize_factor: int = -1, max_width: int = 3840):
        self.cameras = cameras
        self.resize_factor = resize_factor
        self.max_width = max_width

    def __len__(self) -> int:
        return len(self.cameras)

    def get(self, idx: int) -> CameraSample:
        cam = self.cameras[idx]
        img = load_image(cam.image_path, self.resize_factor, self.max_width)
        h, w = img.shape[1], img.shape[2]
        cam.image_width, cam.image_height = w, h
        fx, fy, cx, cy = cam.intrinsics_for_size(w, h)
        return CameraSample(camera=cam, image=img, fx=fx, fy=fy, cx=cx, cy=cy, index=idx)


class InfiniteDataLoader:
    """Infinite random sampler + worker-thread prefetch
    (dataset.hpp:116-135 + create_infinite_dataloader_from_dataset :247-259).

    Samples come out in the order their indices were drawn, whichever worker loads them
    first: every process of a multi-device run that seeds its loader alike sees the same
    sequence, and a resumed run continues the saved one's."""

    def __init__(
        self,
        dataset: CameraDataset,
        num_workers: int = 4,
        prefetch: int = 8,
        seed: int = 0,
        skip: int = 0,  # indices of the stream already consumed (a resumed run's position)
    ):
        self.dataset = dataset
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._index_lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self._perm: list[int] = []
        for _ in range(skip):
            self._next_index()
        self._drawn = 0  # sequence number of the next index drawn
        self._next_out = 0  # sequence number of the next sample handed out
        self._early: dict[int, object] = {}  # loaded ahead of their turn
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(1, num_workers))
        ]
        for w in self._workers:
            w.start()

    def _next_index(self) -> int:
        """The next dataset index of the shuffled stream (the caller holds the lock, or
        no worker runs yet)."""
        if not self._perm:
            self._perm = list(self._rng.permutation(len(self.dataset)))
        return int(self._perm.pop())

    def _next_draw(self) -> tuple[int, int]:
        """(sequence number, dataset index), drawn together under the lock."""
        with self._index_lock:
            seq = self._drawn
            self._drawn += 1
            return seq, self._next_index()

    def _worker(self) -> None:
        while not self._stop.is_set():
            seq, idx = self._next_draw()
            try:
                sample = self.dataset.get(idx)
            except Exception as e:  # surface loader errors to the consumer
                sample = e
            while not self._stop.is_set():
                try:
                    self._queue.put((seq, sample), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[CameraSample]:
        return self

    def __next__(self) -> CameraSample:
        # the consumer keeps draining the queue, so the worker that holds the next
        # sequence number is never blocked on a full queue
        while self._next_out not in self._early:
            seq, item = self._queue.get()
            self._early[seq] = item
        item = self._early.pop(self._next_out)
        self._next_out += 1
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
