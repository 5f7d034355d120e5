"""Persistent staging of a dispatch's camera inputs (the Trainer's ground truth, cameras and
backgrounds) on their way to the device.

A chunk of K steps needs K images [3, H, W] float32 on the device: 104 MB at K = 8 and
1296x840. Stacking them on the host takes a fresh allocation a chunk, above malloc's mmap
threshold, so each chunk page-faults it in again; uploading it from pageable memory blocks
the host until the stream has drained. `InputStaging` keeps its buffers from chunk to
chunk instead, allocated once per shape (`slots` x the image's shape; a shorter chunk
takes their prefix). The loader's images are [3, H, W] views of [H, W, 3] memory
(`io/image.py::load_image` keeps the decoder's order), so each is copied into an
[H, W, 3] slot, a plain memcpy, and the transpose to [3, H, W] runs on the device:

* on a CUDA device the slots are a pinned host buffer, whose filled prefix goes to the
  device in one `non_blocking` copy. An event recorded after that copy gates the next
  refill of the pinned buffer (`waits` counts the refills that had to wait for it). The
  device buffers are rewritten only by work queued behind the steps that read them, so
  the stream's order keeps them safe.
* on any other device (the CPU) the slots are the device's own buffer.

The copies run on `FILL_THREADS` threads (`np.copyto` releases the interpreter lock),
since they meet the loader's threads decoding the next chunk: on an 8-core H100 host a
chunk of 8 took 63-73 ms by `copy_` into [3, H, W] slots one at a time, 25-27 ms on 4
threads, and 19-27 ms on 4 threads into [H, W, 3] slots.

The cameras travel the same way, packed into one [K, 22] float32 buffer a chunk:
world-to-camera (16), position (3), background (3). The values are those of a float32
stack of the inputs, bit for bit.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CAMERA_WIDTH = 22  # w2c (16), position (3), background (3)
FILL_THREADS = 4


class InputStaging:
    def __init__(self, device: torch.device, slots: int):
        self.device = torch.device(device)
        self.slots = max(1, int(slots))
        self.pinned = self.device.type == "cuda"
        self.allocs = 0  # staging buffers allocated (one per shape)
        self.waits = 0  # refills of the pinned buffer that waited for its last upload
        self._images = None  # [n, 3, H, W] on the device: what the steps read
        self._hwc = None  # [n, H, W, 3] on the device: the upload's destination
        self._cameras = None  # [n, 22] on the device
        self._host_hwc = self._host_cameras = None  # pinned on a card, else `_hwc`, `_cameras`
        self._uploaded = torch.cuda.Event() if self.pinned else None
        self._pool = None  # the fill's threads, started at the first call

    def close(self) -> None:
        """Stops the fill's threads (a later call starts them again)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def stage(self, images, w2cs, positions, backgrounds):
        """-> (images [k, 3, H, W], w2cs [k, 4, 4], positions [k, 3], backgrounds [k, 3]) on
        the device, float32: views of the staging buffers, which the next call rewrites."""
        k = len(images)
        self._reserve(k, tuple(images[0].shape))
        if self.pinned and not self._uploaded.query():
            self.waits += 1
            self._uploaded.synchronize()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(FILL_THREADS, thread_name_prefix="staging")
        list(self._pool.map(np.copyto, self._host_hwc[:k].numpy(),
                            [np.asarray(image).transpose(1, 2, 0) for image in images]))
        cams = np.empty((k, CAMERA_WIDTH), np.float32)
        cams[:, :16] = np.reshape(w2cs, (k, 16))
        cams[:, 16:19] = positions
        cams[:, 19:] = backgrounds
        self._host_cameras[:k].copy_(torch.from_numpy(cams))
        if self.pinned:
            self._hwc[:k].copy_(self._host_hwc[:k], non_blocking=True)
            self._cameras[:k].copy_(self._host_cameras[:k], non_blocking=True)
            self._uploaded.record(torch.cuda.current_stream(self.device))
        self._images[:k].copy_(self._hwc[:k].permute(0, 3, 1, 2))
        cams = self._cameras[:k]
        return (self._images[:k], cams[:, :16].unflatten(1, (4, 4)), cams[:, 16:19],
                cams[:, 19:])

    def _reserve(self, k: int, shape: tuple) -> None:
        """Buffers of at least `k` slots of `shape`; kept while both fit."""
        if self._images is not None and self._images.shape[1:] == shape and \
                k <= len(self._images):
            return
        if self.pinned:  # no upload still reads the pinned buffers given up here
            self._uploaded.synchronize()
        n = max(self.slots, k)
        c, h, w = shape
        self._images = torch.empty((n, c, h, w), dtype=torch.float32, device=self.device)
        self._hwc = torch.empty((n, h, w, c), dtype=torch.float32, device=self.device)
        self._cameras = torch.empty((n, CAMERA_WIDTH), dtype=torch.float32,
                                    device=self.device)
        if self.pinned:
            self._host_hwc = torch.empty(self._hwc.shape, dtype=torch.float32,
                                         pin_memory=True)
            self._host_cameras = torch.empty(self._cameras.shape, dtype=torch.float32,
                                             pin_memory=True)
        else:
            self._host_hwc, self._host_cameras = self._hwc, self._cameras
        self.allocs += 1
