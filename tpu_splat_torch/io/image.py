"""8-bit RGB PNG writer on the standard library alone (zlib + struct).

The JAX package writes frames through PIL; the port must not depend on it, so this is a
minimal PNG encoder: one IHDR (8-bit truecolor), one zlib-compressed IDAT with filter
type 0 on every scanline, and IEND. Rounding matches the JAX `save_image`:
clip(0, 1) * 255 + 0.5, truncated to uint8.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG file bytes."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_image(path: str, img_chw: np.ndarray) -> None:
    """float [3,H,W] in [0,1] -> 8-bit PNG file."""
    arr = np.clip(np.asarray(img_chw), 0.0, 1.0)
    arr = (arr.transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(arr)))
