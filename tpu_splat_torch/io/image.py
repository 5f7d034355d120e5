"""Image I/O without PIL: the PNG codec on zlib + numpy, JPEG through nvJPEG.

`load_image` follows the native lane of the JAX package's loader
(`tpu_splat/io/native_loader.py::load_image_native`, `io/native/image_loader.cpp`):
decode to 8-bit RGB (alpha dropped, 16-bit samples cut to their high byte, grey and
palette expanded), an integer-factor box resample with truncating division for
`resize_factor`, then a bilinear long-side cap at `max_width`, and float32 [3, H, W] in
[0, 1] as u8 * (1/255). PNG is decoded here (all five scanline filters); JPEG goes to
nvJPEG (`io/nvjpeg.py`), which raises where the CUDA toolkit is missing: there is no
second decoder to fall back to.

The writer is minimal: one IHDR (8-bit truecolor), one zlib-compressed IDAT with filter
type 0 on every scanline, and IEND. Rounding matches the JAX `save_image`:
clip(0, 1) * 255 + 0.5, truncated to uint8.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_INV255 = np.float32(1.0) / np.float32(255.0)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W, 3] -> PNG file bytes; `level` is zlib's (0-9: speed against size)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def save_image(path: str, img_chw: np.ndarray) -> None:
    """float [3,H,W] in [0,1] -> 8-bit PNG file."""
    arr = np.clip(np.asarray(img_chw), 0.0, 1.0)
    arr = (arr.transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(arr)))


# ----------------------------------------------------------------------- PNG decoder


def _png_chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        yield tag, data[pos + 8:pos + 8 + n]
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND)")


def _unfilter_wavefront(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of the five scanline filters. Average and Paeth are sequential in x
    and every filter but None and Sub reads the row above, so pixel (y, x) needs
    (y, x-1), (y-1, x) and (y-1, x-1): all on the anti-diagonals x + y - 1 and x + y - 2.
    The loop walks the W + H - 1 anti-diagonals, each vectorised over its rows and the
    pixel's bytes. raw [H, W * bpp] uint8."""
    h, stride = raw.shape
    w = stride // bpp
    px = raw.reshape(h, w, bpp).astype(np.int16)
    n_diag = w + h - 1
    # skewed planes: s[d + 2, y + 1] is pixel (y, d - y); row 0 and d < 0 stay zero, the
    # value PNG gives neighbours outside the image
    s = np.zeros((n_diag + 2, h + 1, bpp), np.int16)
    f = ftype.astype(np.int16)[:, None]
    for d in range(n_diag):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        ys = np.arange(y0, y1)
        a = s[d + 1, y0 + 1:y1 + 1]  # left
        b = s[d + 1, y0:y1]  # up
        c = s[d, y0:y1]  # up-left
        fy = f[y0:y1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(fy == 1, a, np.where(fy == 2, b, np.where(
            fy == 3, (a + b) >> 1, np.where(fy == 4, paeth, 0))))
        s[d + 2, y0 + 1:y1 + 1] = (px[ys, d - ys] + pred) & 255
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    return s[xs + ys + 2, ys + 1].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3]: 8- or 16-bit grey, grey+alpha, RGB, RGBA, or 8-bit
    palette; alpha is dropped and 16-bit samples keep their high byte, as libpng's
    strip_alpha / strip_16 do in the JAX package's native lane."""
    ihdr, plte, idat = None, None, []
    for tag, payload in _png_chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(payload)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth {depth}")
    if interlace:
        raise ValueError("interlaced (Adam7) PNGs are not supported")
    nch = _CHANNELS[ctype]
    bpp = nch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    ftype, rows = raw[:, 0], raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    px = _unfilter_wavefront(rows, ftype, bpp) if ftype.any() else rows
    px = px.reshape(h, w, nch, depth // 8)[..., 0]  # 16-bit: big-endian high byte
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        return plte[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


# -------------------------------------------------------------------------- sizes


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR or a JPEG's SOF header, without decoding."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == PNG_SIGNATURE:
            if head[12:16] != b"IHDR":
                raise ValueError(f"{path}: PNG without IHDR")
            return struct.unpack(">II", head[16:24])
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither a PNG nor a JPEG file")
        f.seek(2)
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                raise ValueError(f"{path}: no JPEG frame header")
            m = marker[1]
            if m == 0xFF:  # fill byte
                f.seek(-1, 1)
                continue
            if m in (0x01,) or 0xD0 <= m <= 0xD7:  # markers without a length
                continue
            (n,) = struct.unpack(">H", f.read(2))
            # SOF0-SOF15, less DHT (C4), JPG (C8) and DAC (CC)
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                _, h, w = struct.unpack(">BHH", f.read(5))
                return w, h
            f.seek(n - 2, 1)


def loaded_size(w: int, h: int, resize_factor: int = -1,
                max_width: int = 3840) -> tuple[int, int]:
    """Loaded size of a w x h image: the native lane's `tpusplat_image_size`
    (truncating box, then a long-side cap rounded half up)."""
    if resize_factor and resize_factor > 1:
        w, h = w // resize_factor, h // resize_factor
    long_side = max(w, h)
    if max_width > 0 and long_side > max_width:
        s = max_width / long_side
        w, h = int(w * s + 0.5), int(h * s + 0.5)
    return w, h


# ---------------------------------------------------------------------- resampling


def box_resample(rgb: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor box mean of uint8 [H, W, 3], truncating division (image_loader.cpp
    `box_resample`)."""
    h, w = rgb.shape[0] // factor, rgb.shape[1] // factor
    blocks = rgb[:h * factor, :w * factor].reshape(h, factor, w, factor, 3)
    return (blocks.sum(axis=(1, 3), dtype=np.int32) // (factor * factor)).astype(np.uint8)


def bilinear_resample(rgb: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """Bilinear resample of uint8 [H, W, 3] to [oh, ow, 3] in the float32 arithmetic of
    image_loader.cpp `bilinear_resample` (pixel centres, edge clamp, + 0.5 truncated)."""
    h, w = rgb.shape[:2]
    one, half = np.float32(1.0), np.float32(0.5)

    def axis(n_out, n_in):
        scale = np.float32(n_in) / np.float32(n_out)
        pos = (np.arange(n_out, dtype=np.float32) + half) * scale - half
        i0 = np.clip(pos.astype(np.int32), 0, n_in - 1)  # C++ cast: toward zero
        i1 = np.minimum(i0 + 1, n_in - 1)
        wt = np.clip(pos - i0.astype(np.float32), np.float32(0.0), one)
        return i0, i1, wt

    y0, y1, wy = axis(oh, h)
    x0, x1, wx = axis(ow, w)
    src = rgb.astype(np.float32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top = (one - wx) * src[y0][:, x0] + wx * src[y0][:, x1]
    bot = (one - wx) * src[y1][:, x0] + wx * src[y1][:, x1]
    v = (one - wy) * top + wy * bot
    return (v + half).astype(np.uint8)


def decode_file(path: str | Path) -> np.ndarray:
    """PNG or JPEG file -> uint8 [H, W, 3]."""
    data = Path(path).read_bytes()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        from . import nvjpeg

        return nvjpeg.decode_jpeg(data)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def load_image(path: str | Path, resize_factor: int = -1, max_width: int = 3840) -> np.ndarray:
    """Decode + resample; returns float32 [3, H, W] in [0, 1]."""
    rgb = decode_file(path)
    w, h = loaded_size(rgb.shape[1], rgb.shape[0], resize_factor, max_width)
    if resize_factor and resize_factor > 1:
        rgb = box_resample(rgb, resize_factor)
    if rgb.shape[:2] != (h, w):
        rgb = bilinear_resample(rgb, w, h)
    return np.multiply(rgb.transpose(2, 0, 1), _INV255, dtype=np.float32)
