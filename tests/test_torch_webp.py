"""The port's lossless WebP codec (`tpu_splat_torch/io/webp.py`) against PIL (libwebp).

No JAX. PIL is imported only here, to write and read the fixtures; the port never imports
it. Tolerances: none — a lossless codec is held bit for bit, both ways:

* the port encodes, PIL decodes: equal to the input;
* PIL encodes (libwebp, lossless, at several quality/method settings), the port decodes:
  equal to PIL's own decode. The fixtures are chosen so that libwebp writes each part of
  the format, and the decoder's counts (`decode_webp_lossless(stats=...)`) show that it
  did: the predictor and cross-colour transforms (smooth gradients), subtract green
  (noise), colour indexing with pixels bundled 8, 4 and 2 to a byte and unbundled (2, 4,
  16 and 200 colours), LZ77 backward references (smooth gradients, repeated rows, the
  large plane), colour-cache hits (smooth gradients, odd widths), meta prefix codes (the
  1000x1000 plane), a 1x1 image;
* a truncated or corrupted file raises ValueError.
"""

import functools
import io

import numpy as np
import pytest

from tpu_splat_torch.io import webp
from tpu_splat_torch.io.webp import decode_webp_lossless, encode_webp_lossless

Image = pytest.importorskip("PIL.Image")

PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = 1, 2, 4, 8  # transform mask bits


def pil_encode(rgba: np.ndarray, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(bio, format="WEBP", lossless=True, **kw)
    return bio.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _palette(rng, n, h, w):
    colours = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    return colours[rng.integers(0, n, (h, w))]


def _smooth(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 3 + y) % 256, (x + 2 * y) % 256, (x * x // 7 + y) % 256,
                     np.full_like(x, 255)], -1).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def fixtures() -> dict:
    rng = np.random.default_rng(3)
    big = (_smooth(1000, 1000) + rng.integers(0, 3, (1000, 1000, 4))).astype(np.uint8)
    big[..., 3] = 255
    return {
        "noise": rng.integers(0, 256, (64, 65, 4), dtype=np.uint8),
        "smooth": _smooth(70, 91),
        "rows": np.repeat(rng.integers(0, 256, (1, 33, 4), dtype=np.uint8), 40, 0),
        "colors2": _palette(rng, 2, 31, 45),
        "colors4": _palette(rng, 4, 29, 47),
        "colors16": _palette(rng, 16, 33, 35),
        "colors200": _palette(rng, 200, 50, 51),
        "1x1": rng.integers(0, 256, (1, 1, 4), dtype=np.uint8),
        "odd_width": (rng.integers(0, 4, (13, 77, 4)) * 60).astype(np.uint8),
        "1000x1000": big,
    }


# what libwebp (quality 100) must have written into each fixture, as the decoder counts it
EXPECTED_FEATURES = {
    "noise": lambda s: s["transform_mask"] & SUBTRACT_GREEN,
    "smooth": lambda s: (s["transform_mask"] & PREDICTOR and s["transform_mask"] & CROSS_COLOR
                         and s["backrefs"] > 0 and s["cache_hits"] > 0),
    "rows": lambda s: s["backrefs"] > 0,
    "colors2": lambda s: s["index_bits"] == 3,
    "colors4": lambda s: s["index_bits"] == 2,
    "colors16": lambda s: s["index_bits"] == 1,
    "colors200": lambda s: s["index_bits"] == 0,
    "1x1": lambda s: True,
    "odd_width": lambda s: s["cache_hits"] > 0,
    "1000x1000": lambda s: s["groups"] > 1 and s["backrefs"] > 0,
}

SETTINGS = [dict(quality=100), dict(quality=100, method=6), dict(quality=0, method=0),
            dict(quality=50, method=4, exact=True)]


@pytest.mark.parametrize("name", list(EXPECTED_FEATURES))
def test_port_encodes_pil_decodes(name):
    rgba = fixtures()[name]
    data = encode_webp_lossless(rgba)
    assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8L"
    np.testing.assert_array_equal(pil_decode(data), rgba)
    np.testing.assert_array_equal(decode_webp_lossless(data), rgba)


@pytest.mark.parametrize("name", list(EXPECTED_FEATURES))
def test_pil_encodes_port_decodes(name):
    rgba = fixtures()[name]
    for kw in SETTINGS if name != "1000x1000" else SETTINGS[:1]:
        data = pil_encode(rgba, **kw)
        stats = {}
        got = decode_webp_lossless(data, stats)
        np.testing.assert_array_equal(got, pil_decode(data), err_msg=str(kw))
        if kw == SETTINGS[0]:
            assert EXPECTED_FEATURES[name](stats), (name, stats)


def test_transparent_pixels_keep_their_colour():
    """The port writes the colour under alpha 0 exactly (libwebp may replace it unless
    asked for `exact`)."""
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (17, 19, 4), dtype=np.uint8)
    rgba[::2, :, 3] = 0
    np.testing.assert_array_equal(decode_webp_lossless(encode_webp_lossless(rgba)), rgba)
    np.testing.assert_array_equal(pil_decode(encode_webp_lossless(rgba)), rgba)


def test_truncated_or_corrupt_files_raise():
    rgba = fixtures()["smooth"]
    for data in (pil_encode(rgba, quality=100), encode_webp_lossless(rgba)):
        for cut in (len(data) - 1, len(data) // 2, 30, 12, 3):
            with pytest.raises(ValueError):
                decode_webp_lossless(data[:cut])
        with pytest.raises(ValueError, match="not a readable"):
            decode_webp_lossless(b"RIFX" + data[4:])
        bad = bytearray(data)
        bad[20] ^= 0xFF  # the VP8L signature byte
        with pytest.raises(ValueError):
            decode_webp_lossless(bytes(bad))
    # a stream cut inside its pixel data, with the RIFF sizes rewritten to match
    data = encode_webp_lossless(fixtures()["noise"])
    payload = data[20:len(data) // 2]
    cut = (b"RIFF" + (len(payload) + 12).to_bytes(4, "little") + b"WEBPVP8L"
           + len(payload).to_bytes(4, "little") + payload)
    with pytest.raises(ValueError, match="truncated"):
        decode_webp_lossless(cut)


def test_encoder_rejects_what_webp_cannot_hold():
    with pytest.raises(ValueError):
        encode_webp_lossless(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        encode_webp_lossless(np.zeros((1, webp.MAX_SIZE + 1, 4), np.uint8))
