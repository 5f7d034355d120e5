"""Blender / NeRF-synthetic `transforms.json` loader (port of `tpu_splat/io/transforms.py`;
an image size missing from the JSON is read from the file's header, not through PIL).

Mirrors src/loader/formats/transforms.cpp:61-200: `camera_angle_x` or `fl_x/fl_y` intrinsics,
per-frame `file_path` + c2w matrices with the OpenGL->COLMAP axis flip (negate Y/Z columns),
then inverted to world-to-camera R/T.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from ..core.camera import Camera
from .image import image_size


def is_transforms_dataset(base: Path) -> bool:
    base = Path(base)
    return any(
        (base / n).exists() for n in ("transforms.json", "transforms_train.json")
    ) or (base.suffix == ".json" and base.exists())


def load_transforms(base: str | Path) -> tuple[list[Camera], np.ndarray]:
    """Returns (cameras, scene_center). Image sizes resolved lazily by the dataset
    (file read at first image load)."""
    base = Path(base)
    if base.is_file():
        tpath, root = base, base.parent
    else:
        root = base
        tpath = base / "transforms_train.json"
        if not tpath.exists():
            tpath = base / "transforms.json"
    meta = json.loads(Path(tpath).read_text())

    frames = meta["frames"]
    cameras: list[Camera] = []
    positions = []
    for uid, frame in enumerate(frames):
        c2w = np.array(frame["transform_matrix"], np.float32)
        # OpenGL convention -> COLMAP: flip Y and Z axes of the rotation
        c2w[:3, 1:3] *= -1.0
        w2c = np.linalg.inv(c2w)
        r, t = w2c[:3, :3], w2c[:3, 3]

        fp = frame["file_path"]
        img_path = root / fp
        if not img_path.exists():
            for ext in (".png", ".jpg", ".jpeg", ".JPG", ".PNG"):
                if (root / (fp + ext)).exists():
                    img_path = root / (fp + ext)
                    break

        w = int(frame.get("w", meta.get("w", 0)))
        h = int(frame.get("h", meta.get("h", 0)))
        if w == 0 or h == 0:  # from the PNG IHDR / JPEG SOF header
            w, h = image_size(img_path)

        if "fl_x" in meta or "fl_x" in frame:
            fx = float(frame.get("fl_x", meta.get("fl_x")))
            fy = float(frame.get("fl_y", meta.get("fl_y", fx)))
        else:
            angle_x = float(meta["camera_angle_x"])
            fx = fy = 0.5 * w / math.tan(0.5 * angle_x)
        cx = float(frame.get("cx", meta.get("cx", w / 2.0)))
        cy = float(frame.get("cy", meta.get("cy", h / 2.0)))

        cameras.append(
            Camera(
                R=r, T=t, focal_x=fx, focal_y=fy, center_x=cx, center_y=cy,
                image_path=str(img_path), image_name=Path(fp).name, uid=uid,
                camera_width=w, camera_height=h,
            )
        )
        positions.append(c2w[:3, 3])

    scene_center = np.mean(np.stack(positions), axis=0).astype(np.float32)
    return cameras, scene_center
