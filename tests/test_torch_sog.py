"""The port's SOG export and import (`tpu_splat_torch/io/sog.py`) against the JAX package's.

On the CPU; no kernel is involved. Tolerances:

* Morton order, the log transforms, quaternion packing and unpacking: bit-equal.
* k-means++ init: the same centres, bit for bit (the same numpy draws; the cumulative
  probabilities round alike at these sizes).
* `kmeans` after one Lloyd step: labels equal except where the top two scores of a point
  lie within 1e-5 of each other, relative (float32 dot products summed in another order),
  centroids rtol 1e-5 (atol 1e-6 near zero); after 10 steps the inertia within 1e-3
  relative. `kmeans_1d`: its init is numpy on both sides; labels and centroids as above.
* Cross-reading: a `.sog` the port writes (its own WebP codec) read by JAX `load_sog`
  (PIL) gives the arrays the port's `load_sog` gives, bit for bit; a `.sog` the JAX
  package writes (PIL / libwebp) read by the port gives JAX's arrays, bit for bit; in the
  zip and the directory form, at SH degree 0, 3 and 4.
* Two JAX faults are pinned (ROADMAP.md Queue 3): PIL's lossless writer replaces the
  sh0 labels under alpha 0 (Gaussians with opacity < 1/255), and JAX `kmeans` raises when
  the points have fewer distinct values than the palette.
"""

import functools
import json

import numpy as np
import pytest

from tpu_splat.io import sog as jsog
from tpu_splat_torch.io import sog as tsog

N = 700  # below 1024: a palette of n (the n < 1024 branch of the palette size)


def _arrays(n: int, sh_degree: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2 - 1
    return dict(
        means=rng.normal(0, 2, (n, 3)).astype(np.float32),
        sh0=rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        shN=rng.normal(0, 0.05, (n, k, 3)).astype(np.float32),
        scaling_raw=rng.normal(-3, 0.5, (n, 3)).astype(np.float32),
        rotation_raw=rng.normal(0, 1, (n, 4)).astype(np.float32),
        opacity_raw=rng.normal(-1, 1, (n, 1)).astype(np.float32),
    )


def test_morton_transforms_and_quaternions_bit_equal():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 3, (5000, 3)).astype(np.float32)
    pts[:50] = pts[50:100]  # ties in the stable sort
    np.testing.assert_array_equal(tsog.morton_encode(pts), jsog.morton_encode(pts))
    np.testing.assert_array_equal(tsog.morton_order(pts), jsog.morton_order(pts))
    v = rng.normal(0, 5, (5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsog.log_transform(v), jsog.log_transform(v))
    np.testing.assert_array_equal(tsog.inv_log_transform(v), jsog.inv_log_transform(v))
    q = rng.normal(0, 1, (5000, 4)).astype(np.float32)
    q[:4] = [[0, 0, 0, 0], [0, -1, 0, 0], [0.5, -0.5, 0.5, -0.5], [1e-30, 0, 0, 0]]
    packed = tsog.pack_quaternions(q)
    np.testing.assert_array_equal(packed, jsog.pack_quaternions(q))
    np.testing.assert_array_equal(tsog.unpack_quaternions(packed),
                                  jsog.unpack_quaternions(packed))


def _inertia(x, cent, labels):
    return float(np.sum((x.astype(np.float64) - cent[labels].astype(np.float64)) ** 2))


def _near_tie(x, cent, labels_a, labels_b, rel=1e-5):
    """Points whose two labels score within `rel` of each other (x.c - |c|^2/2)."""
    half = 0.5 * np.sum(cent.astype(np.float64) ** 2, axis=1)
    score = x.astype(np.float64) @ cent.T.astype(np.float64) - half
    rows = np.arange(len(x))
    sa, sb = score[rows, labels_a], score[rows, labels_b]
    return np.abs(sa - sb) <= rel * np.maximum(np.abs(sa), np.abs(sb))


@functools.lru_cache(maxsize=1)
def _kmeans_data():
    rng = np.random.default_rng(1)
    return rng.normal(0, 0.05, (3000, 45)).astype(np.float32)


def test_kmeans_init_and_one_lloyd_step_match_jax():
    x = _kmeans_data()
    k = 256
    init = tsog.kmeans_init(x, k, seed=0, device="cpu").numpy()
    # the JAX init, drawn as jsog.kmeans draws it
    rng = np.random.default_rng(0)
    sub = x[rng.choice(len(x), min(len(x), 1 << 16), replace=False)]
    centers = [sub[rng.integers(len(sub))]]
    d2 = np.sum((sub - centers[0]) ** 2, axis=1)
    for _ in range(k - 1):
        nxt = sub[rng.choice(len(sub), p=d2 / max(d2.sum(), 1e-12))]
        centers.append(nxt)
        d2 = np.minimum(d2, np.sum((sub - nxt) ** 2, axis=1))
    np.testing.assert_array_equal(init, np.stack(centers))

    cj, lj = jsog.kmeans(x, k, iterations=1)
    ct, lt = tsog.kmeans(x, k, iterations=1, device="cpu")
    differ = lj != lt
    assert not (differ & ~_near_tie(x, init, lj, lt)).any()
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-6)


def test_kmeans_ten_steps_inertia_matches_jax():
    x = _kmeans_data()[:2000]
    cj, lj = jsog.kmeans(x, 256, iterations=10, seed=3)
    ct, lt = tsog.kmeans(x, 256, iterations=10, seed=3, device="cpu")
    ij, it = _inertia(x, cj, lj), _inertia(x, ct, lt)
    assert abs(it - ij) <= 1e-3 * ij, (it, ij)


def test_kmeans_1d_matches_jax():
    rng = np.random.default_rng(2)
    v = np.concatenate([rng.normal(-3, 0.5, 3000), rng.normal(-1, 0.2, 900)]).astype(np.float32)
    for iters in (1, 10):
        cj, lj = jsog.kmeans_1d(v, 256, iters)
        ct, lt = tsog.kmeans_1d(v, 256, iters, device="cpu")
        np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-6)
        assert (lj == lt).mean() >= 0.999 and np.abs(lj - lt).max() <= 1


def test_kmeans_on_too_few_distinct_points():
    """JAX: `rng.choice` raises once every point coincides with a chosen centre. The port
    then picks uniformly; the duplicate centres stay empty and keep their value."""
    x = np.repeat(np.random.default_rng(4).normal(0, 1, (10, 6)).astype(np.float32), 30, 0)
    with pytest.raises(ValueError, match="(?i)probabilities do not sum to 1"):
        jsog.kmeans(x, 64, iterations=2)
    cent, labels = tsog.kmeans(x, 64, iterations=2, device="cpu")
    assert cent.shape == (64, 6) and np.isfinite(cent).all()
    # every point on its centre (the mean of 30 copies rounds within an ulp or two)
    np.testing.assert_allclose(cent[labels], x, rtol=1e-6, atol=1e-7)


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("sh_degree,form", [(0, "zip"), (3, "dir"), (4, "zip")])
def test_port_written_sog_reads_in_jax(tmp_path, sh_degree, form):
    arrays = _arrays(N, sh_degree, seed=10 + sh_degree)
    path = tmp_path / ("m.sog" if form == "zip" else "m")
    tsog.save_sog(path, arrays, device="cpu")
    got = tsog.load_sog(path if form == "zip" else path / "meta.json")
    _equal(got, jsog.load_sog(path if form == "zip" else path / "meta.json"))
    assert got["shN"].shape == (N, (sh_degree + 1) ** 2 - 1, 3)
    # the planes are what the port encoded, and the means (Morton-ordered) within a
    # 16-bit step of the log range
    planes, meta = tsog.sog_planes(arrays, device="cpu")
    blobs = tsog.read_sog_files(path)
    assert blobs["meta.json"] == json.dumps(meta, indent=1).encode()
    for name, plane in planes.items():
        np.testing.assert_array_equal(tsog.decode_webp_lossless(blobs[name]), plane)
    span = np.asarray(meta["means"]["maxs"]) - np.asarray(meta["means"]["mins"])
    order = tsog.morton_order(arrays["means"])
    err = np.abs(tsog.log_transform(got["means"])
                 - tsog.log_transform(arrays["means"][order]))
    assert (err <= span / 65535.0 + 1e-5).all()


@pytest.mark.parametrize("sh_degree,form", [(0, "dir"), (3, "zip"), (4, "dir")])
def test_jax_written_sog_reads_in_port(tmp_path, sh_degree, form):
    arrays = _arrays(N, sh_degree, seed=20 + sh_degree)
    path = tmp_path / ("m.sog" if form == "zip" else "m")
    jsog.save_sog(path, arrays)
    _equal(tsog.load_sog(path), jsog.load_sog(path))


def test_jax_writer_loses_sh0_labels_under_zero_alpha(tmp_path):
    """PIL writes lossless WebP without `exact`, so libwebp replaces the RGB under alpha 0:
    the sh0 labels of every Gaussian with 255 * sigmoid(opacity) < 1 change. The port's
    planes keep them."""
    arrays = _arrays(N, 0, seed=30)
    arrays["opacity_raw"][::5] = -7.0  # sigmoid < 1/255
    jsog.save_sog(tmp_path / "j.sog", arrays)
    tsog.save_sog(tmp_path / "t.sog", arrays, device="cpu")
    planes, _ = tsog.sog_planes(arrays, device="cpu")
    want = planes["sh0.webp"]
    jax_plane = tsog.decode_webp_lossless(tsog.read_sog_files(tmp_path / "j.sog")["sh0.webp"])
    port_plane = tsog.decode_webp_lossless(tsog.read_sog_files(tmp_path / "t.sog")["sh0.webp"])
    np.testing.assert_array_equal(port_plane, want)
    changed = (jax_plane != want).any(-1)
    assert changed.any() and (want[changed][:, 3] == 0).all()
