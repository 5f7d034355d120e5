"""SOG v2 compressed-splat format: export + import (port of `tpu_splat/io/sog.py`).

Reference: src/core/sogs.cpp (writer) and src/loader/formats/sogs.cpp (reader). Layout
(meta.json + lossless WebP planes, zipped when the output path ends in .sog):

  * gaussians Morton-reordered into width x height RGBA planes, width = ceil(sqrt(n)/4)*4;
  * means: per-axis signed log transform copysign(log(1+|v|), v), normalized to [0,1] by
    min/max, 16-bit split into means_l/means_u planes;
  * quats: normalized, largest component dropped, the other three packed *sqrt(2) into
    8 bits, alpha = 252 + largest_idx;
  * scales / sh0: 1-d k-means(256) over all 3 channels jointly, labels in RGB planes,
    codebook in meta.json; sh0's alpha channel stores 255*sigmoid(opacity);
  * shN: vector k-means into a palette (<= 64*1024 entries), then a 1-d k-means(256) over
    the centroid values as codebook; the centroids plane is band-major 64-wide, the labels
    plane stores the 16-bit palette index.

The Morton order, the transforms, the quaternion packing, the plane layout, meta.json and
the .sog zip or directory are copies of the JAX module's, bit for bit. The planes go
through the port's own WebP codec (`io/webp.py`) where the JAX package calls PIL.

`kmeans` and `kmeans_1d` run in torch on `device` (the CUDA card by default) and compute
what the JAX ones compute: the same k-means++ init from the same numpy draws, the same
Lloyd update (argmax of x.c - |c|^2/2, first index on ties; empty clusters keep their
centre). The assignment is chunked over the points so that a [chunk, k] float32 score
block stays at 2 GiB (the JAX version forms all [N, k] at once: 262 GB at 1M points and a
65,536 palette). The scatter-adds are `index_add_`; on the card they are float atomics, so
centroids can differ in their last bits between runs (and from the CPU), and a point
within that rounding of two centroids can change its label.
"""

from __future__ import annotations

import json
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .webp import decode_webp_lossless, encode_webp_lossless

SCORE_BLOCK_BYTES = 1 << 31  # the assignment's [chunk, k] float32 score block


# ----------------------------------------------------------------------- morton ordering


def morton_encode(positions: np.ndarray) -> np.ndarray:
    """63-bit Morton codes from 21-bit-quantized positions (morton_encoding.cu:21-100)."""
    pts = np.asarray(positions, np.float64)
    mins = pts.min(axis=0)
    maxs = pts.max(axis=0)
    q = ((pts - mins) / np.maximum(maxs - mins, 1e-12) * ((1 << 21) - 1)).astype(np.uint64)

    def split_by_3(a: np.ndarray) -> np.ndarray:
        x = a & np.uint64(0x1FFFFF)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    return (
        split_by_3(q[:, 0])
        | (split_by_3(q[:, 1]) << np.uint64(1))
        | (split_by_3(q[:, 2]) << np.uint64(2))
    )


def morton_order(positions: np.ndarray) -> np.ndarray:
    return np.argsort(morton_encode(positions), kind="stable")


# ------------------------------------------------------------------------------- k-means


def kmeans_init(data: np.ndarray, k: int, seed: int = 0,
                device: str | torch.device | None = None) -> torch.Tensor:
    """k-means++ init on a subsample of at most 2^16 points, as the JAX `kmeans` draws it:
    the subsample and the first centre from `np.random.default_rng(seed)`, then one
    `rng.random()` per further pick, searched in the float64 cumulative sum of the
    distance-squared probabilities (which is what `rng.choice(m, p=probs)` does). The
    picks stay on the device, so no pick waits on a copy to the host; on the card each
    pick is one replay of a CUDA graph of its ~20 launches. Where every point
    coincides with a chosen centre (all distances 0) JAX's `rng.choice` raises; here the
    pick is then uniform over the subsample.

    The distances and their total are float32, as in JAX, but each is summed in float64
    and rounded once, so that the card and the CPU, which add in different orders, get
    the same bits and so the same picks (a float32 sum in another order moves the
    cumulative probabilities by ~1e-10, enough to move a pick now and then over 65,535 of
    them). -> the k initial centres [k, D] on `device`"""
    dev = resolve_device(device)
    data = np.asarray(data, np.float32)
    n = data.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    sub_np = data[rng.choice(n, min(n, 1 << 16), replace=False)]
    m = sub_np.shape[0]
    first = int(rng.integers(m))
    draws = torch.as_tensor(rng.random(k - 1), dtype=torch.float64, device=dev)
    sub = torch.as_tensor(sub_np, device=dev)
    picks = torch.empty(k, dtype=torch.long, device=dev)
    picks[0] = first

    def dist2(c):
        return torch.sum(((sub - c) ** 2).double(), dim=1).float()

    d2 = dist2(sub[first])
    uniform = torch.full_like(d2, 1.0 / m)
    j = torch.zeros((), dtype=torch.long, device=dev)  # the pick's draw; picks[j + 1] is set

    def pick():
        total = torch.sum(d2.double()).float()
        probs = torch.where(total > 0, d2 / torch.clamp_min(total, 1e-12), uniform)
        cdf = torch.cumsum(probs.double(), 0)
        cdf = cdf / cdf[-1]
        nxt = torch.searchsorted(cdf, draws.index_select(0, j), right=True).clamp_max_(m - 1)
        picks.index_copy_(0, j + 1, nxt)
        d2.copy_(torch.minimum(d2, dist2(sub.index_select(0, nxt))))
        j.add_(1)

    if dev.type == "cuda" and k > 2:
        # ~20 small launches a pick, 65,535 picks: replay them as one CUDA graph per pick
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            pick()  # the first pick, run before the capture (warm-up)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the live viewer's HTTP threads may render on the card meanwhile
        # (their work is not captured; in the default mode it would void the capture)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            pick()
        for _ in range(k - 2):
            graph.replay()
    else:
        for _ in range(k - 1):
            pick()
    return sub[picks]


def kmeans(data: np.ndarray, k: int, iterations: int = 10, seed: int = 0,
           device: str | torch.device | None = None, timings: dict | None = None):
    """Lloyd k-means on `device`: the k-means++ init of `kmeans_init`, then `iterations`
    steps, each assigning every point to argmax(x @ c.T - 0.5 |c|^2) in chunks and moving
    each centre to its points' mean. -> (centroids [k, D], labels [N] int32), numpy; the
    labels are those of the last step's assignment, against the centres before its
    update, as in JAX. `timings` (seconds): kmeans_init, kmeans_lloyd."""
    dev = resolve_device(device)
    data = np.asarray(data, np.float32)
    n, d = data.shape
    k = min(k, n)
    t0 = time.perf_counter()
    cent = kmeans_init(data, k, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # so that the init's time is its own
    t1 = time.perf_counter()
    x = torch.as_tensor(data, device=dev)
    ones = torch.ones(n, device=dev)
    chunk = max(1, SCORE_BLOCK_BYTES // (4 * k))
    labels = torch.empty(n, dtype=torch.long, device=dev)
    for _ in range(max(iterations, 1)):
        half = 0.5 * torch.sum(cent * cent, dim=1)
        for s in range(0, n, chunk):
            score = x[s:s + chunk] @ cent.T
            score -= half
            labels[s:s + chunk] = torch.argmax(score, dim=1)
            del score
        sums = torch.zeros((k, d), device=dev).index_add_(0, labels, x)
        cnts = torch.zeros((k,), device=dev).index_add_(0, labels, ones)
        cent = torch.where(cnts[:, None] > 0, sums / torch.clamp_min(cnts, 1.0)[:, None], cent)
    out = cent.cpu().numpy(), labels.to(torch.int32).cpu().numpy()
    if timings is not None:
        timings["kmeans_init"] = t1 - t0
        timings["kmeans_lloyd"] = time.perf_counter() - t1
    return out


def kmeans_1d(data: np.ndarray, k: int = 256, iterations: int = 10, seed: int = 0,
              device: str | torch.device | None = None):
    """1-d k-means (kernels/kmeans.cu:226) on `device`: the sorted-quantile init of numpy,
    then Lloyd steps that assign by searching the midpoints of the sorted centres (left
    side). -> (centroids [k], labels [N] int32), numpy, as the JAX `kmeans_1d`."""
    dev = resolve_device(device)
    v = np.asarray(data, np.float32).reshape(-1)
    k = min(k, v.size)
    init = np.quantile(v, np.linspace(0, 1, k)).astype(np.float32)
    x = torch.as_tensor(v, device=dev)
    ones = torch.ones_like(x)
    cent = torch.as_tensor(init, device=dev)
    labels = None
    for _ in range(max(iterations, 1)):
        c_sorted = torch.sort(cent).values
        edges = 0.5 * (c_sorted[1:] + c_sorted[:-1])
        labels = torch.searchsorted(edges, x)
        sums = torch.zeros((k,), device=dev).index_add_(0, labels, x)
        cnts = torch.zeros((k,), device=dev).index_add_(0, labels, ones)
        cent = torch.where(cnts > 0, sums / torch.clamp_min(cnts, 1.0), c_sorted)
    return cent.cpu().numpy(), labels.to(torch.int32).cpu().numpy()


# ------------------------------------------------------------------------ quat pack/unpack


def log_transform(v: np.ndarray) -> np.ndarray:
    return np.copysign(np.log(np.abs(v) + 1.0), v)


def inv_log_transform(v: np.ndarray) -> np.ndarray:
    return np.copysign(np.exp(np.abs(v)) - 1.0, v)


def pack_quaternions(q: np.ndarray) -> np.ndarray:
    """[N,4] wxyz -> [N,4] uint8 smallest-three encoding (sogs.cpp:60-143)."""
    q = np.asarray(q, np.float32)
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    qn = np.where(norm > 0, q / np.maximum(norm, 1e-12), [[1, 0, 0, 0]])
    max_idx = np.argmax(np.abs(qn), axis=1)
    sign = np.sign(np.take_along_axis(qn, max_idx[:, None], axis=1))
    sign = np.where(sign == 0, 1.0, sign)
    qn = qn * sign  # largest component positive
    qs = qn * np.sqrt(2.0, dtype=np.float32)

    out = np.empty((q.shape[0], 4), np.uint8)
    cols = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])[max_idx]  # [N,3]
    rest = np.take_along_axis(qs, cols, axis=1)
    out[:, :3] = np.clip((rest * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    out[:, 3] = (252 + max_idx).astype(np.uint8)
    return out


def unpack_quaternions(packed: np.ndarray) -> np.ndarray:
    """Inverse of pack_quaternions -> [N,4] wxyz normalized."""
    packed = np.asarray(packed)
    max_idx = packed[:, 3].astype(np.int32) - 252
    rest = (packed[:, :3].astype(np.float32) / 255.0 - 0.5) * 2.0 / np.sqrt(2.0)
    missing = np.sqrt(np.maximum(1.0 - np.sum(rest * rest, axis=1), 0.0))
    q = np.empty((packed.shape[0], 4), np.float32)
    cols = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])[max_idx]
    np.put_along_axis(q, cols, rest, axis=1)
    np.put_along_axis(q, max_idx[:, None], missing[:, None], axis=1)
    return q


# --------------------------------------------------------------------------- webp helpers


def _to_plane(values_rgba: np.ndarray, width: int, height: int) -> np.ndarray:
    """[N,4] uint8 -> [H,W,4] plane, identity layout, padding 255."""
    plane = np.full((width * height, 4), 255, np.uint8)
    plane[: values_rgba.shape[0]] = values_rgba
    return plane.reshape(height, width, 4)


def sog_planes(arrays: dict, kmeans_iterations: int = 10,
               device: str | torch.device | None = None,
               timings: dict | None = None) -> tuple[dict, dict]:
    """The SOG planes of a splat and their meta.json, before any WebP encoding.
    -> ({file name: [H, W, 4] uint8 plane}, meta). `timings` (seconds): morton,
    kmeans_init, kmeans_lloyd, kmeans_1d_scales, kmeans_1d_sh0, kmeans_1d_shN."""
    dev = resolve_device(device)
    tm = {} if timings is None else timings
    t0 = time.perf_counter()
    means = np.asarray(arrays["means"], np.float32)
    n = means.shape[0]
    order = morton_order(means)  # sogs.cpp:378
    tm["morton"] = time.perf_counter() - t0

    width = int(np.ceil(np.sqrt(n) / 4.0)) * 4
    height = int(np.ceil(n / width))

    planes: dict[str, np.ndarray] = {}
    meta: dict = {"version": 2, "count": int(n), "width": width, "height": height}

    # means: log transform -> minmax-normalize -> 16-bit split
    mlog = log_transform(means)
    mins = mlog.min(axis=0)
    maxs = mlog.max(axis=0)
    mnorm = np.clip((mlog[order] - mins) / (maxs - mins + 1e-10), 0, 1)
    m16 = (mnorm * 65535.0).astype(np.uint16)
    lo = np.full((n, 4), 255, np.uint8)
    hi = np.full((n, 4), 255, np.uint8)
    lo[:, :3] = (m16 & 0xFF).astype(np.uint8)
    hi[:, :3] = (m16 >> 8).astype(np.uint8)
    planes["means_l.webp"] = _to_plane(lo, width, height)
    planes["means_u.webp"] = _to_plane(hi, width, height)
    meta["means"] = {
        "mins": [float(v) for v in mins],
        "maxs": [float(v) for v in maxs],
        "files": ["means_l.webp", "means_u.webp"],
    }

    # quats
    planes["quats.webp"] = _to_plane(
        pack_quaternions(np.asarray(arrays["rotation_raw"])[order]), width, height)
    meta["quats"] = {"files": ["quats.webp"]}

    # scales: joint 1-d k-means(256) over all channels (column-major, sogs.cpp:513-520)
    t0 = time.perf_counter()
    scales = np.asarray(arrays["scaling_raw"], np.float32)
    sc_flat = scales.T.reshape(-1)  # column-major: all x, then y, then z
    sc_cent, sc_labels = kmeans_1d(sc_flat, 256, kmeans_iterations, device=dev)
    tm["kmeans_1d_scales"] = time.perf_counter() - t0
    sc_lab3 = sc_labels.reshape(3, n).T[order]  # [N,3]
    plane = np.full((n, 4), 255, np.uint8)
    plane[:, :3] = sc_lab3.astype(np.uint8)
    planes["scales.webp"] = _to_plane(plane, width, height)
    meta["scales"] = {"codebook": [float(v) for v in sc_cent], "files": ["scales.webp"]}

    # sh0 (+opacity in alpha)
    t0 = time.perf_counter()
    sh0 = np.asarray(arrays["sh0"], np.float32).reshape(n, 3)
    c_cent, c_labels = kmeans_1d(sh0.T.reshape(-1), 256, kmeans_iterations, device=dev)
    tm["kmeans_1d_sh0"] = time.perf_counter() - t0
    c_lab3 = c_labels.reshape(3, n).T[order]
    opac = 1.0 / (1.0 + np.exp(-np.asarray(arrays["opacity_raw"], np.float32).reshape(n)))
    plane = np.zeros((n, 4), np.uint8)
    plane[:, :3] = c_lab3.astype(np.uint8)
    plane[:, 3] = np.clip(255.0 * opac[order], 0, 255).astype(np.uint8)
    planes["sh0.webp"] = _to_plane(plane, width, height)
    meta["sh0"] = {"codebook": [float(v) for v in c_cent], "files": ["sh0.webp"]}

    # shN: vector k-means palette + 1-d codebook of centroid values (sogs.cpp:620-718)
    shN = np.asarray(arrays.get("shN"), np.float32) if arrays.get("shN") is not None else None
    if shN is not None and shN.size > 0 and shN.shape[1] > 0:
        coeffs = shN.shape[1]
        flat = shN.reshape(n, coeffs * 3)
        # min(64, max(1, 2^floor(log2(n/1024)))) * 1024, the JAX package's palette size
        pow2 = int(2 ** np.floor(np.log2(n / 1024.0))) if n >= 1024 else 1
        palette_size = min(min(64, max(1, pow2)) * 1024, n)
        cents, labels = kmeans(flat, palette_size, kmeans_iterations, device=dev, timings=tm)
        actual = cents.shape[0]
        t0 = time.perf_counter()
        cb_cent, cb_labels = kmeans_1d(cents.reshape(-1), 256, kmeans_iterations, device=dev)
        tm["kmeans_1d_shN"] = time.perf_counter() - t0

        cw = 64 * coeffs
        ch = (actual + 63) // 64
        cbuf = np.full((cw * ch, 4), 255, np.uint8)
        cb_lab = cb_labels.reshape(actual, coeffs * 3)
        for c in range(3):
            # band-major: channel c of coefficient j lives at column j + c*coeffs
            vals = cb_lab[:, c * coeffs : (c + 1) * coeffs]  # [actual, coeffs]
            idx = np.arange(actual)[:, None] * coeffs + np.arange(coeffs)[None, :]
            cbuf[idx.reshape(-1), c] = vals.reshape(-1).astype(np.uint8)
        planes["shN_centroids.webp"] = cbuf.reshape(ch, cw, 4)

        lab = labels[order]
        lbuf = np.full((n, 4), 255, np.uint8)
        lbuf[:, 0] = (lab & 0xFF).astype(np.uint8)
        lbuf[:, 1] = ((lab >> 8) & 0xFF).astype(np.uint8)
        lbuf[:, 2] = 0
        planes["shN_labels.webp"] = _to_plane(lbuf, width, height)

        degree = {3: 1, 8: 2, 15: 3, 24: 4}.get(coeffs, 3)
        meta["shN"] = {
            "codebook": [float(v) for v in cb_cent],
            "palette_size": int(actual),
            "bands": degree,
            "coeffs": int(coeffs),
            "files": ["shN_centroids.webp", "shN_labels.webp"],
        }
    return planes, meta


# -------------------------------------------------------------------------------- writer


def save_sog(path: str | Path, arrays: dict, kmeans_iterations: int = 10,
             device: str | torch.device | None = None,
             timings: dict | None = None) -> tuple[dict, dict]:
    """Write a .sog zip (or a directory of files when `path` has no .sog suffix); the
    k-means runs on `device` (the CUDA card when None). -> (planes, meta) as written.

    arrays: means [N,3], sh0 [N,1,3], shN [N,K-1,3], scaling_raw [N,3] (log),
    rotation_raw [N,4] (unnormalized wxyz), opacity_raw [N,1] (logit). `timings`
    (seconds): those of `sog_planes`, webp_encode (the planes in parallel threads), zip
    (the writing of the zip or files)."""
    path = Path(path)
    tm = {} if timings is None else timings
    planes, meta = sog_planes(arrays, kmeans_iterations, device, tm)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(len(planes), 8)) as pool:
        files = dict(zip(planes, pool.map(encode_webp_lossless, planes.values())))
    tm["webp_encode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    meta_bytes = json.dumps(meta, indent=1).encode()
    if path.suffix == ".sog":
        path.parent.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
            z.writestr("meta.json", meta_bytes)
            for name, data in files.items():
                z.writestr(name, data)
    else:
        path.mkdir(parents=True, exist_ok=True)
        (path / "meta.json").write_bytes(meta_bytes)
        for name, data in files.items():
            (path / name).write_bytes(data)
    tm["zip"] = time.perf_counter() - t0
    return planes, meta


# -------------------------------------------------------------------------------- reader


def read_sog_files(path: str | Path) -> dict[str, bytes]:
    """The files of a .sog zip, or of the directory holding meta.json (or `path` itself)."""
    path = Path(path)
    if path.is_file() and path.suffix == ".sog":
        with zipfile.ZipFile(path) as z:
            return {name: z.read(name) for name in z.namelist()}
    root = path if path.is_dir() else path.parent
    return {p.name: p.read_bytes() for p in root.iterdir() if p.is_file()}


def decode_planes(blobs: dict[str, bytes], names: list[str]) -> dict[str, np.ndarray]:
    """Decode the named WebP planes, in parallel threads (the decoder releases the GIL)."""
    with ThreadPoolExecutor(max_workers=min(len(names), 8) or 1) as pool:
        return dict(zip(names, pool.map(lambda nm: decode_webp_lossless(blobs[nm]), names)))


def load_sog(path: str | Path) -> dict:
    """Read .sog zip or meta.json directory -> raw parameter dict
    (loader: src/loader/formats/sogs.cpp:102-530)."""
    blobs = read_sog_files(path)
    meta = json.loads(blobs["meta.json"])
    n = meta["count"]
    names = [f for key in ("means", "quats", "scales", "sh0", "shN") if key in meta
             for f in meta[key]["files"]]
    decoded = decode_planes(blobs, names)

    def plane(name):
        return decoded[name].reshape(-1, 4)[:n]

    lo = plane(meta["means"]["files"][0]).astype(np.uint16)
    hi = plane(meta["means"]["files"][1]).astype(np.uint16)
    m16 = (lo[:, :3] | (hi[:, :3] << 8)).astype(np.float32) / 65535.0
    mins = np.asarray(meta["means"]["mins"], np.float32)
    maxs = np.asarray(meta["means"]["maxs"], np.float32)
    means = inv_log_transform(m16 * (maxs - mins) + mins)

    quats = unpack_quaternions(plane(meta["quats"]["files"][0]))

    sc_cb = np.asarray(meta["scales"]["codebook"], np.float32)
    sc = plane(meta["scales"]["files"][0])[:, :3].astype(np.int32)
    scaling_raw = sc_cb[np.clip(sc, 0, len(sc_cb) - 1)]

    c_cb = np.asarray(meta["sh0"]["codebook"], np.float32)
    sh0p = plane(meta["sh0"]["files"][0])
    sh0 = c_cb[np.clip(sh0p[:, :3].astype(np.int32), 0, len(c_cb) - 1)][:, None, :]
    op = np.clip(sh0p[:, 3].astype(np.float32) / 255.0, 1e-6, 1 - 1e-6)
    opacity_raw = np.log(op / (1.0 - op))[:, None]

    if "shN" in meta:
        coeffs = meta["shN"]["coeffs"]
        actual = meta["shN"]["palette_size"]
        cb = np.asarray(meta["shN"]["codebook"], np.float32)
        cplane = decoded[meta["shN"]["files"][0]].reshape(-1, 4)
        cb_lab = np.zeros((actual, coeffs * 3), np.int32)
        idx = np.arange(actual)[:, None] * coeffs + np.arange(coeffs)[None, :]
        for c in range(3):
            cb_lab[:, c * coeffs : (c + 1) * coeffs] = cplane[idx.reshape(-1), c].reshape(
                actual, coeffs
            )
        cents = cb[np.clip(cb_lab, 0, len(cb) - 1)]
        lp = plane(meta["shN"]["files"][1])
        labels = lp[:, 0].astype(np.int32) | (lp[:, 1].astype(np.int32) << 8)
        # the flat coefficient index is row-major over [coeffs, 3] (writer `flat` layout),
        # so a plain reshape restores [N, coeffs, 3]
        shN = cents[np.clip(labels, 0, actual - 1)].reshape(n, coeffs, 3)
    else:
        shN = np.zeros((n, 0, 3), np.float32)

    return {
        "means": means.astype(np.float32),
        "sh0": sh0.astype(np.float32),
        "shN": shN.astype(np.float32),
        "scaling_raw": scaling_raw.astype(np.float32),
        "rotation_raw": quats.astype(np.float32),
        "opacity_raw": opacity_raw.astype(np.float32),
    }
