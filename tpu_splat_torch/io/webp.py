"""Lossless WebP (VP8L, RFC 9649) without PIL: the SOG planes' codec.

`encode_webp_lossless(rgba [H, W, 4] uint8) -> bytes` is numpy: a RIFF/WEBP/VP8L file with
the subtract-green transform (where it lowers the entropy of red and blue) and a predictor
transform (each 16x16 block takes the one of
`PRED_MODES` whose residuals are smallest, summed as log2(1 + |residual|)), no colour
cache, no LZ77, one prefix-code group. Each of the five prefix codes is a
Huffman code of its histogram, limited to 15 bits by raising the smallest counts (as libwebp
does); a code with one or two symbols below 256 is written as a simple code (one symbol: a
code of length zero). The symbol stream is packed into bytes with vectorised numpy, not a
loop per pixel.

`decode_webp_lossless(bytes) -> [H, W, 4] uint8` reads what libwebp writes, the whole
lossless format (`io/native/vp8l_decode.cpp`): every transform, LZ77 with the distance
map, the colour cache and meta prefix codes. Huffman decoding is sequential per symbol,
so it is C++, built with g++ at first use into `build/io/` at the repository root (listed
in .gitignore), named by a hash of the source, and loaded with ctypes (which releases the
GIL, so planes decode in parallel threads). Where g++ is missing or the build fails it
raises and says so: there is no other decoder to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import heapq
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "vp8l_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "io"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

MAX_SIZE = 1 << 14  # VP8L stores width - 1 and height - 1 in 14 bits
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABETS = (256 + 24, 256, 256, 256, 40)  # green + lengths, red, blue, alpha, distance
PRED_BITS = 4  # predictor blocks of 16 x 16 pixels
# the predictor modes the encoder tries: left, top, average(left, top), select, and
# clamped left + top - top-left (mode numbers of RFC 9649 section 4.1)
PRED_MODES = (1, 2, 7, 11, 12)


# --------------------------------------------------------------------------- decoder


def _build() -> Path:
    if shutil.which("g++") is None:
        raise RuntimeError("WebP decoding builds its VP8L decoder with g++, not found")
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"vp8l_decode-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building the VP8L decoder failed:\n{r.stderr[-2000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the whole file or none
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.tpu_splat_vp8l_size.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.tpu_splat_vp8l_size.restype = ctypes.c_int
            lib.tpu_splat_vp8l_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.tpu_splat_vp8l_decode.restype = ctypes.c_int
            lib.tpu_splat_vp8l_error.argtypes = [ctypes.c_int]
            lib.tpu_splat_vp8l_error.restype = ctypes.c_char_p
            _lib = lib
        return _lib


STAT_KEYS = ("transform_mask", "index_bits", "backrefs", "cache_hits", "groups", "cache_bits")


def decode_webp_lossless(data: bytes, stats: dict | None = None) -> np.ndarray:
    """Lossless WebP file bytes -> uint8 [H, W, 4] (RGBA, as stored). `stats`, when given,
    is filled with what the file used (STAT_KEYS; the transform mask has bit t set for
    transform type t: 0 predictor, 1 cross-colour, 2 subtract green, 3 colour indexing)."""
    lib = _library()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.tpu_splat_vp8l_size(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"not a readable lossless WebP: {lib.tpu_splat_vp8l_error(rc).decode()}")
    out = np.empty((h.value, w.value, 4), np.uint8)
    counts = np.zeros(len(STAT_KEYS), np.int64)
    rc = lib.tpu_splat_vp8l_decode(data, len(data), out.ctypes.data, w.value, h.value,
                                   counts.ctypes.data)
    if rc != 0:
        raise ValueError(f"corrupt lossless WebP: {lib.tpu_splat_vp8l_error(rc).decode()}")
    if stats is not None:
        stats.update(zip(STAT_KEYS, counts.tolist()))
    return out


# --------------------------------------------------------------------------- encoder


class _Bits:
    """(value, bit count) pairs, written LSB first; packed once at the end."""

    def __init__(self) -> None:
        self.values: list[np.ndarray] = []
        self.nbits: list[np.ndarray] = []

    def put(self, value: int, nbits: int) -> None:
        self.values.append(np.array([value], np.uint64))
        self.nbits.append(np.array([nbits], np.int64))

    def put_array(self, values: np.ndarray, nbits: np.ndarray) -> None:
        self.values.append(np.asarray(values, np.uint64))
        self.nbits.append(np.asarray(nbits, np.int64))

    def tobytes(self) -> bytes:
        values = np.concatenate(self.values)
        nbits = np.concatenate(self.nbits)
        ends = np.cumsum(nbits)
        starts = ends - nbits
        nbytes = int((ends[-1] + 7) // 8) if len(ends) else 0
        keep = nbits > 0
        starts, values = starts[keep], values[keep]
        byte = starts >> 3
        v = values << (starts & 7).astype(np.uint64)  # <= 24 + 7 bits
        out = np.zeros(nbytes + 4, np.float64)
        # bits of different writes never share a bit position, so sums are ORs
        for k in range(4):
            lane = ((v >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.float64)
            out += np.bincount(byte + k, weights=lane, minlength=nbytes + 4)
        return out[:nbytes].astype(np.uint8).tobytes()


def _huffman_lengths(hist: np.ndarray, limit: int) -> np.ndarray:
    """Code lengths of a Huffman code of `hist` (>= 2 used symbols), at most `limit` bits:
    the smallest counts are raised to count_min, doubled until the code fits."""
    used = np.flatnonzero(hist)
    count_min = 1
    while True:
        counts = np.maximum(hist[used], count_min)
        heap = [(int(c), i, (i,)) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        depth = np.zeros(len(used), np.int64)
        tie = len(used)
        while len(heap) > 1:
            c0, _, s0 = heapq.heappop(heap)
            c1, _, s1 = heapq.heappop(heap)
            depth[list(s0 + s1)] += 1
            heapq.heappush(heap, (c0 + c1, tie, s0 + s1))
            tie += 1
        if depth.max() <= limit:
            lengths = np.zeros(len(hist), np.int64)
            lengths[used] = depth
            return lengths
        count_min *= 2


def _canonical_codes(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes of `lengths`, bit-reversed for LSB-first writing, and the bits each
    symbol takes in the stream (0 for every symbol of a code with one used symbol)."""
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(len(lengths), np.uint64)
    used = np.flatnonzero(lengths)
    if len(used) <= 1:
        return codes, np.zeros(len(lengths), np.int64)
    order = used[np.lexsort((used, lengths[used]))]
    code, prev_len = 0, int(lengths[order[0]])
    for k, s in enumerate(order):
        n = int(lengths[s])
        if k:
            code = (code + 1) << (n - prev_len)
        prev_len = n
        codes[s] = int(f"{code:0{n}b}"[::-1], 2)
    return codes, lengths


def _length_tokens(lengths: np.ndarray) -> list[tuple[int, int, int]]:
    """Run-length tokens (symbol, extra value, extra bits) of a code-length sequence: 17/18
    for runs of zeros, 16 for repeats of the previous non-zero length (RFC 9649 3.7.2.1.2)."""
    tokens, i, n, prev = [], 0, len(lengths), 8
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and lengths[i + run] == v:
            run += 1
        i += run
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                tokens.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                tokens.append((17, run - 3, 3))
                run = 0
            tokens += [(0, 0, 0)] * run
            continue
        if v != prev:
            tokens.append((v, 0, 0))
            prev = v
            run -= 1
        while run >= 3:
            r = min(run, 6)
            tokens.append((16, r - 3, 2))
            run -= r
        tokens += [(v, 0, 0)] * run
    return tokens


def _write_code(bits: _Bits, hist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Write the prefix code of `hist`; -> (codes, bit counts) per symbol."""
    used = np.flatnonzero(hist)  # literals only: every used symbol is below 256
    if len(used) <= 2:
        # simple code; one symbol (or none used: symbol 0) has a code of length zero
        syms = [int(s) for s in used] or [0]
        bits.put(1, 1)
        bits.put(len(syms) - 1, 1)
        if syms[0] < 2:
            bits.put(0, 1)
            bits.put(syms[0], 1)
        else:
            bits.put(1, 1)
            bits.put(syms[0], 8)
        if len(syms) == 2:
            bits.put(syms[1], 8)
        lengths = np.zeros(len(hist), np.int64)
        lengths[syms] = 1
        return _canonical_codes(lengths)
    lengths = _huffman_lengths(hist, 15)
    tokens = _length_tokens(lengths)
    cl_hist = np.bincount([t[0] for t in tokens], minlength=19)
    cl_lengths = (_huffman_lengths(cl_hist, 7) if np.count_nonzero(cl_hist) > 1
                  else (cl_hist > 0).astype(np.int64))
    cl_codes, cl_bits = _canonical_codes(cl_lengths)
    ordered = [int(cl_lengths[s]) for s in _CODE_LENGTH_ORDER]
    num = max(4, max(i + 1 for i, v in enumerate(ordered) if v))
    bits.put(0, 1)  # normal code
    bits.put(num - 4, 4)
    for v in ordered[:num]:
        bits.put(v, 3)
    bits.put(0, 1)  # max_symbol: the whole alphabet
    sym = np.array([t[0] for t in tokens])
    extra = np.array([t[1] for t in tokens], np.uint64)
    extra_n = np.array([t[2] for t in tokens], np.int64)
    pairs_v = np.stack([cl_codes[sym], extra], 1).reshape(-1)
    pairs_n = np.stack([cl_bits[sym], extra_n], 1).reshape(-1)
    bits.put_array(pairs_v, pairs_n)
    return _canonical_codes(lengths)


def _write_image(bits: _Bits, argb: np.ndarray, main: bool = False) -> None:
    """An image of [H, W, 4] uint8 channels in the order a, r, g, b, with no colour cache
    and (`main`: the main image says so) one prefix-code group: literals only."""
    a, r, g, b = (argb[..., k].reshape(-1).astype(np.int64) for k in range(4))
    bits.put(0, 1)  # no colour cache
    if main:
        bits.put(0, 1)  # no meta prefix codes
    tables = []
    for ch, alphabet in zip((g, r, b, a), _ALPHABETS[:4]):
        tables.append(_write_code(bits, np.bincount(ch, minlength=alphabet)))
    _write_code(bits, np.zeros(_ALPHABETS[4], np.int64))
    n = a.size
    values = np.empty((n, 4), np.uint64)
    nbits = np.empty((n, 4), np.int64)
    for k, (ch, (codes, lens)) in enumerate(zip((g, r, b, a), tables)):
        values[:, k] = codes[ch]
        nbits[:, k] = lens[ch]
    bits.put_array(values.reshape(-1), nbits.reshape(-1))


def _entropy_bits(channels: np.ndarray) -> float:
    """Shannon bits of each channel (last axis) coded alone by its own histogram, summed."""
    total = 0.0
    for k in range(channels.shape[-1]):
        hist = np.bincount(channels[..., k].reshape(-1), minlength=256)
        p = hist[hist > 0] / hist.sum()
        total -= float(hist[hist > 0] @ np.log2(p))
    return total


def _predictions(p: np.ndarray) -> dict[int, np.ndarray]:
    """Each PRED_MODES prediction of every pixel with a left and a top neighbour (x, y >= 1)
    from the pixels themselves, per channel, as int16 [H-1, W-1, 4]."""
    p = p.astype(np.int16)
    L, T, TL = p[1:, :-1], p[:-1, 1:], p[:-1, :-1]
    pl = np.abs(T - TL).sum(-1, keepdims=True)  # RFC 9649 Select: distances to L + T - TL
    pt = np.abs(L - TL).sum(-1, keepdims=True)
    return {1: L, 2: T, 7: (L + T) >> 1, 11: np.where(pl < pt, L, T),
            12: np.clip(L + T - TL, 0, 255)}


def _predictor_modes(p: np.ndarray) -> np.ndarray:
    """Per 16x16 block, the mode of PRED_MODES whose residuals cost least, estimated as the
    summed log2 of each residual's magnitude (+1): [ceil(H/16), ceil(W/16)] int."""
    h, w, _ = p.shape
    bh, bw = -(-h // (1 << PRED_BITS)), -(-w // (1 << PRED_BITS))
    cost = np.zeros((len(PRED_MODES), bh, bw))
    inner = p[1:, 1:].astype(np.int16)
    ys = (np.arange(1, h) >> PRED_BITS)[:, None]
    xs = (np.arange(1, w) >> PRED_BITS)[None, :]
    cell = (ys * bw + xs).reshape(-1)
    for k, pred in enumerate(_predictions(p).values()):
        res = ((inner - pred) & 255).astype(np.int16)
        res = np.minimum(res, 256 - res)  # wrap-around distance from zero
        c = np.log2(1.0 + res).sum(-1).reshape(-1)
        cost[k] = np.bincount(cell, weights=c, minlength=bh * bw).reshape(bh, bw)
    return np.asarray(PRED_MODES)[np.argmin(cost, axis=0)]


def _predict_residuals(p: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """Residuals p - prediction (mod 256) under the predictor transform: the first pixel
    against black (0xff000000), the first row against the left, the first column against
    the top, the rest against its block's mode."""
    h, w, _ = p.shape
    res = p.astype(np.int16).copy()
    res[0, 0] -= np.array([255, 0, 0, 0], np.int16)  # a, r, g, b of 0xff000000
    res[0, 1:] -= p[0, :-1]
    res[1:, 0] -= p[:-1, 0]
    preds = _predictions(p)
    mode = modes[(np.arange(1, h) >> PRED_BITS)[:, None], (np.arange(1, w) >> PRED_BITS)[None]]
    chosen = np.zeros((h - 1, w - 1, 4), np.int16)
    for m, pred in preds.items():
        chosen = np.where((mode == m)[..., None], pred, chosen)
    res[1:, 1:] -= chosen
    return (res & 255).astype(np.uint8)


def encode_webp_lossless(rgba: np.ndarray) -> bytes:
    """uint8 [H, W, 4] RGBA -> lossless WebP file bytes (every value kept exactly, also
    the colour of fully transparent pixels)."""
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected uint8 [H, W, 4], got {rgba.dtype} {rgba.shape}")
    h, w, _ = rgba.shape
    if not (1 <= w <= MAX_SIZE and 1 <= h <= MAX_SIZE):
        raise ValueError(f"a WebP is 1..{MAX_SIZE} pixels a side, got {w}x{h}")
    argb = rgba[..., [3, 0, 1, 2]].astype(np.int16)  # a, r, g, b
    bits = _Bits()
    bits.put(0x2F, 8)
    bits.put(w - 1, 14)
    bits.put(h - 1, 14)
    bits.put(int((rgba[..., 3] != 255).any()), 1)
    bits.put(0, 3)
    # subtract green (r -= g, b -= g) where it lowers the red and blue histograms' entropy
    # (it helps where the channels move together, hurts where they are independent)
    sub = (argb[..., [1, 3]] - argb[..., 2:3]) & 255
    if _entropy_bits(sub) < _entropy_bits(argb[..., [1, 3]]):
        bits.put(1, 1)
        bits.put(2, 2)
        argb[..., [1, 3]] = sub
    if h > 1 and w > 1:  # the predictor transform, 16x16 blocks
        modes = _predictor_modes(argb)
        bits.put(1, 1)
        bits.put(0, 2)
        bits.put(PRED_BITS - 2, 3)
        mode_img = np.zeros(modes.shape + (4,), np.uint8)
        mode_img[..., 2] = modes  # the mode is the block pixel's green
        mode_img[..., 0] = 255
        _write_image(bits, mode_img)
        argb = _predict_residuals(argb, modes)
    bits.put(0, 1)  # no further transform
    _write_image(bits, np.asarray(argb, np.uint8), main=True)
    payload = bits.tobytes()
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
