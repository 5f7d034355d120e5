"""COLMAP dataset reader (port of `tpu_splat/io/colmap.py`): cameras.bin/images.bin/points3D.bin (+ .txt variants).

Behavior mirrors src/loader/formats/colmap.cpp: 11 camera models mapped to
PINHOLE/FISHEYE + radial/tangential coefficient arrays (colmap.cpp:684-790, SURVEY.md §8.11),
qvec/tvec -> world-to-camera R/T, scene_center = mean of camera positions. Standalone numpy
implementation of the (public, documented) COLMAP binary schema.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..core.camera import Camera, CameraModelType

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def _read_cameras_bin(path: Path) -> dict[int, dict]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODELS[model_id]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cams[cam_id] = dict(model=name, width=int(w), height=int(h),
                                params=np.array(params, np.float64))
    return cams


def _read_cameras_txt(path: Path) -> dict[int, dict]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        cam_id, name, w, h = int(tok[0]), tok[1], int(tok[2]), int(tok[3])
        cams[cam_id] = dict(model=name, width=w, height=h,
                            params=np.array([float(t) for t in tok[4:]], np.float64))
    return cams


def _read_images_bin(path: Path) -> list[dict]:
    images = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            image_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            f.seek(npts * 24, 1)  # skip 2D points (x,y double + point3D_id u64)
            images.append(dict(image_id=image_id, qvec=qvec, tvec=tvec,
                               camera_id=cam_id, name=name.decode()))
    return images


def _read_images_txt(path: Path) -> list[dict]:
    images = []
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is the 2D-point list
        tok = lines[i].split()
        images.append(dict(
            image_id=int(tok[0]),
            qvec=np.array([float(t) for t in tok[1:5]]),
            tvec=np.array([float(t) for t in tok[5:8]]),
            camera_id=int(tok[8]),
            name=tok[9],
        ))
    return images


def _read_points3d_bin(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    means = np.empty((n, 3), np.float32)
    colors = np.empty((n, 3), np.float32)
    off = 8
    for i in range(n):
        # point3D_id u64, xyz 3d, rgb 3B, error d, track_len u64, track (2i each)
        xyz = struct.unpack_from("<3d", data, off + 8)
        rgb = struct.unpack_from("<3B", data, off + 32)
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        means[i] = xyz
        colors[i] = rgb
        off += 51 + track_len * 8
    return means, colors


def _read_points3d_txt(path: Path) -> tuple[np.ndarray, np.ndarray]:
    means, colors = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        means.append([float(t) for t in tok[1:4]])
        colors.append([float(t) for t in tok[4:7]])
    return np.array(means, np.float32), np.array(colors, np.float32)


def _camera_from_colmap(model: str, params: np.ndarray, rc: bool = False):
    """Intrinsics + distortion mapping (colmap.cpp:684-790). Returns
    (fx, fy, cx, cy, radial, tangential, model_type)."""
    radial = np.zeros(0, np.float32)
    tangential = np.zeros(0, np.float32)
    mtype = CameraModelType.PINHOLE
    if model == "SIMPLE_PINHOLE":
        fx = fy = params[0]; cx, cy = params[1], params[2]
    elif model == "PINHOLE":
        fx, fy, cx, cy = params[:4]
    elif model == "SIMPLE_RADIAL":
        fx = fy = params[0]; cx, cy = params[1], params[2]
        if not rc:  # --rc RealityCapture workaround drops k1
            radial = np.array([params[3]], np.float32)
    elif model == "RADIAL":
        fx = fy = params[0]; cx, cy = params[1], params[2]
        radial = np.array(params[3:5], np.float32)
    elif model == "OPENCV":
        fx, fy, cx, cy = params[:4]
        radial = np.array(params[4:6], np.float32)
        tangential = np.array(params[6:8], np.float32)
    elif model == "FULL_OPENCV":
        fx, fy, cx, cy = params[:4]
        radial = np.array(np.concatenate([params[4:6], params[8:12]]), np.float32)
        tangential = np.array(params[6:8], np.float32)
    elif model == "OPENCV_FISHEYE":
        fx, fy, cx, cy = params[:4]
        radial = np.array(params[4:8], np.float32)
        mtype = CameraModelType.FISHEYE
    elif model in ("SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        fx = fy = params[0]; cx, cy = params[1], params[2]
        radial = np.array(params[3:], np.float32)
        mtype = CameraModelType.FISHEYE
    elif model == "THIN_PRISM_FISHEYE":
        fx, fy, cx, cy = params[:4]
        radial = np.array(params[4:8], np.float32)
        tangential = np.zeros(0, np.float32)
        mtype = CameraModelType.FISHEYE
    else:
        raise ValueError(f"Unsupported COLMAP camera model: {model}")
    return float(fx), float(fy), float(cx), float(cy), radial, tangential, mtype


def find_sparse_dir(base: Path) -> Path:
    """COLMAP layouts: base/sparse/0, base/sparse, or base itself."""
    for cand in (base / "sparse" / "0", base / "sparse", base):
        if (cand / "cameras.bin").exists() or (cand / "cameras.txt").exists():
            return cand
    raise FileNotFoundError(f"No COLMAP sparse reconstruction under {base}")


def is_colmap_dataset(base: Path) -> bool:
    try:
        find_sparse_dir(Path(base))
        return True
    except FileNotFoundError:
        return False


def load_colmap(
    base: str | Path, images_folder: str = "images", rc: bool = False
) -> tuple[list[Camera], np.ndarray, np.ndarray, np.ndarray]:
    """Returns (cameras, points, colors_in_[0,1], scene_center)."""
    base = Path(base)
    sparse = find_sparse_dir(base)

    if (sparse / "cameras.bin").exists():
        cams = _read_cameras_bin(sparse / "cameras.bin")
        images = _read_images_bin(sparse / "images.bin")
        points, colors = _read_points3d_bin(sparse / "points3D.bin")
    else:
        cams = _read_cameras_txt(sparse / "cameras.txt")
        images = _read_images_txt(sparse / "images.txt")
        points, colors = _read_points3d_txt(sparse / "points3D.txt")

    images.sort(key=lambda d: d["name"])
    cameras: list[Camera] = []
    positions = []
    for uid, im in enumerate(images):
        c = cams[im["camera_id"]]
        fx, fy, cx, cy, radial, tangential, mtype = _camera_from_colmap(
            c["model"], c["params"], rc
        )
        r = qvec_to_rotmat(im["qvec"])
        t = im["tvec"].astype(np.float32)
        cameras.append(
            Camera(
                R=r, T=t, focal_x=fx, focal_y=fy, center_x=cx, center_y=cy,
                radial_distortion=radial, tangential_distortion=tangential,
                camera_model_type=mtype,
                image_path=str(base / images_folder / im["name"]),
                image_name=im["name"], uid=uid,
                camera_width=c["width"], camera_height=c["height"],
            )
        )
        positions.append(-r.T @ t)

    scene_center = np.mean(np.stack(positions), axis=0).astype(np.float32)
    return cameras, points, colors / 255.0, scene_center
