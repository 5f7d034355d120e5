"""Numpy fixtures shared by the PyTorch port's tests; imports neither JAX nor the port."""

import numpy as np


def blend_fixture():
    """The 6-tile unaligned-segment fixture of test_blend_kernel_variants_parity."""
    rng = np.random.default_rng(3)
    TS, GW, GH, CH = 16, 3, 2, 256
    n_rows, max_chunks = 12, 2
    N = n_rows * CH
    s = rng.uniform(1.0, 4.0, N)
    ca = 1 / (s * s)
    cc = 1 / (s * s * rng.uniform(0.5, 2.0, N))
    feats = np.stack(
        [rng.uniform(0, GW * TS, N), rng.uniform(0, GH * TS, N), ca,
         rng.uniform(-0.3, 0.3, N) * np.sqrt(ca * cc), cc,
         rng.uniform(0.1, 1.0, N)] + [rng.uniform(0, 1, N)] * 3
        + [rng.uniform(1, 10, N)], 1).astype(np.float32)
    flat = np.zeros((16, N + max_chunks * CH + 128), np.float32)
    flat[:10, :N] = feats.T
    count = np.asarray([512, 512, 500, 512, 100, 300], np.int32)
    seg_start = np.asarray([0, 512, 1024, 1524, 2036, 2136], np.int32)
    return flat, seg_start, count, dict(n_tiles=GW * GH, grid_w=GW, tile_size=TS)


def to_jax_bf16(t):
    """A torch bfloat16 tensor as a JAX bfloat16 array with the same bits."""
    import jax.numpy as jnp
    import torch

    return jnp.asarray(t.contiguous().view(torch.int16).numpy()).view(jnp.bfloat16)


def emission_runs(seed=0, n=700, long_run=1500):
    """Random contiguous emission runs over n Gaussians: short runs, empty runs and one
    very long run. -> (counts, start, end, total), int32 arrays and an int."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    counts[rng.random(n) < 0.25] = 0
    counts[n // 3] = long_run
    counts[-3:] = 0  # the last owner is not the last Gaussian
    end = np.cumsum(counts).astype(np.int32)
    return counts, (end - counts).astype(np.int32), end, int(end[-1])


# A 32x24 JPEG written by PIL (quality 90, 4:4:4 chroma, so no upsampling filter enters
# the comparison) of `jpeg_fixture_source()`, and the libjpeg decode of it (the JAX
# package's native lane) stored as an int8 difference from that source, zlib + base64.
_JPEG_B64 = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoMDAsKCwsNDhIQ"
    "DQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsNFBQUFBQUFBQUFBQUFBQUFBQU"
    "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/wAARCAAYACADAREAAhEBAxEB/8QAHwAAAQUBAQEB"
    "AQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKB"
    "kaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1"
    "dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcF"
    "BAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5"
    "OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0"
    "tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD8/wDRfAv3"
    "f3f6VjCsc+XZrtqd7ovgX7v7v9K7oVj9Py7NdtTvdF8C/d/d/pXbCsfp2XZrtqd7ovgX7v7v9K74Vj9Oy7Nd"
    "tTj9F8C/d/d/pX5zCsf5aZdmu2p2EFj/AGZEttjGwdPrz/Wvi8zfNi5v0/JH+l3hdV9vwhgqnf2n/p2Z13gL"
    "Qv7amuvl3eVs/Xd/hXv8Nz5HV/7d/U8rxGxX1aeC8/af+2HrOi+Bfu/u/wBK++hWPkcuzTbU4/RfAv3f3f6V"
    "+dQrH+WmXZrtqd7ovgX7v7v9K7oVj9Oy7NdtTvdF8C/d/d/pXbCsfp2XZrtqd7ovgX7v7v8ASu+FY/T8uzXb"
    "U//Z"
)
_JPEG_LIBJPEG_DELTA_B64 = (
    "eNptVtuSIzsIA9yd+f+PPVVbmxgOknBnHnYqlXHTNhch5JhZWrpZWZZVf3qNJ4cFC3xgabvTUtjPhSfX/ZfY"
    "572nHyuxx0J+cNqjLPp1wekqxwoRfLWdkfpoYJvTW691HE5xFtGDPn1Z+PiM9tAL5EwLNsISE5alICmLhGdn"
    "gScnPBrrdWSABHvREZxl98OiN5RKYGrs84TjjEufWDAuUJvwiY8JzzYki0Pc8hxsEFOYB+EzZtDv5psomZ3M"
    "GKYdqE5VsCZ/HHdCp/4FDjnRZfCBxNXriT59RH7BNNV0n/0oNOzUJ5SHEPDEztnuapjlxjFFKVIEfW0PqX2n"
    "G9yT2vPk04v9lAefQJqZR9rg1l9proWw8dJx9WXxlfoIHPLgwNN45QISXAqBw5KRC/pVNThYvrL+e33ubJ8r"
    "m2q1VjTdm3s7/e7D9zv+/OyNDPLtF6FM8bHLeXDoXhXJv+rhczvxn0/9ib1ydSH/9v+J98qdhq+6bQo9fFBJ"
    "7I84OWyYtvjPtrfnVZdndIPkv4ev/W+74D8XUst4of8/KEOsxxSqz3I7XHGQth7eXts+SLt3L/kncXtk4B+o"
    "sfjCwG7zGz2dif7OkViM2QbNxCtfajFSg6khSgzJjYHDyLfPG4IAKvgHX9kgiUfd4BiicV58QtJQkjhN1obr"
    "tQst6NrDXpDBpErZvSr7VUT8BQyfzRHTLDw+R2i+vB3Oa2fPwlpX+2ycIQJ197pRAtXqgn/P29c7PFqcNHxe"
    "PsL7aNR3rgWSOM9gjcgNJ1//jf4FlPK6kMB+dXEZy3JtjYawNXa27V112NF/O/j4pCB7xaNU0jreCy6ucYqP"
    "EEnHmvilK0RqyFaO/otR0n8xCpJdI4lxStM2xbW5FyYO52j0HxfB0B495QURv3j71Yri1SAJOKoycyRsWd8v"
    "bN2lJ7pB1NMvb0cKUaikH3LGMmHgHNXR/DryP3vmPnL6FGKT/8KbUo0+GBQ13KRUw2efi2t8uc3Ac2yle/of"
    "gwOTUh+JKDmWpXvHj7bTTvf1616owe9UNBPLCfJzH+XJZ9vRf8xCSf/1o0F3H/wGfx7IzpBcj/5L2HT9TIta"
    "AFjic8XPLIBT9vS6MPerfvXUptd+VID6/52jEPn/B9k1jQk="
)


def jpeg_fixture_source():
    """The uint8 [24, 32, 3] image the fixture JPEG encodes: gradients and a red box."""
    ys, xs = np.mgrid[0:24, 0:32]
    img = np.stack([xs * 8, ys * 10, (xs + ys) * 4], -1).astype(np.float32)
    img[8:16, 10:20] = [250, 40, 30]
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_fixture():
    """-> (JPEG file bytes, libjpeg's RGB decode of them as uint8 [24, 32, 3])."""
    import base64
    import zlib

    delta = np.frombuffer(zlib.decompress(base64.b64decode("".join(_JPEG_LIBJPEG_DELTA_B64))),
                          np.int8).reshape(24, 32, 3)
    rgb = (jpeg_fixture_source().astype(np.int16) + delta).astype(np.uint8)
    return base64.b64decode("".join(_JPEG_B64)), rgb
