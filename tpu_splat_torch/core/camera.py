"""Camera model (port of `tpu_splat/core/camera.py`): per-image intrinsics/extrinsics, mirroring `include/core/camera.hpp:16-125`.

Host-side dataclass (numpy); the train step consumes a flat, jit-friendly pack of
(w2c [4,4], cam_position [3], fx, fy, cx, cy, W, H). Image pixels are loaded lazily by the
dataloader (reference: `Camera::load_and_get_image`, `src/core/camera.cpp:101-165`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import numpy as np


class CameraModelType(Enum):
    """Mirrors `gsplat/Common.h:46-50`."""

    PINHOLE = 0
    ORTHO = 1
    FISHEYE = 2


@dataclass
class Camera:
    R: np.ndarray  # [3,3] world-to-camera rotation
    T: np.ndarray  # [3] world-to-camera translation
    focal_x: float
    focal_y: float
    center_x: float
    center_y: float
    # distortion (empty arrays for pinhole); used only by the GUT path
    radial_distortion: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    tangential_distortion: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    camera_model_type: CameraModelType = CameraModelType.PINHOLE
    image_path: str = ""
    image_name: str = ""
    uid: int = -1
    # full-resolution size as recorded by the loader
    camera_width: int = 0
    camera_height: int = 0
    # actual loaded size (after resize_factor / max_width); set by the dataloader
    image_width: int = 0
    image_height: int = 0

    def __post_init__(self):
        self.R = np.asarray(self.R, np.float32).reshape(3, 3)
        self.T = np.asarray(self.T, np.float32).reshape(3)
        if self.image_width == 0:
            self.image_width = self.camera_width
        if self.image_height == 0:
            self.image_height = self.camera_height

    @property
    def world_view_transform(self) -> np.ndarray:
        """4x4 world-to-camera matrix (reference: camera.hpp lazy `world_view_transform`)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R
        m[:3, 3] = self.T
        return m

    @property
    def cam_position(self) -> np.ndarray:
        return (-self.R.T @ self.T).astype(np.float32)

    def intrinsics_for_size(self, width: int, height: int) -> tuple[float, float, float, float]:
        """Rescale intrinsics from camera_{width,height} to a loaded size.

        Mirrors `Camera::K()` ratio rescaling (`src/core/camera.cpp:92-99`).
        """
        sx = width / float(self.camera_width) if self.camera_width else 1.0
        sy = height / float(self.camera_height) if self.camera_height else 1.0
        return self.focal_x * sx, self.focal_y * sy, self.center_x * sx, self.center_y * sy

    def K(self) -> np.ndarray:
        fx, fy, cx, cy = self.intrinsics_for_size(self.image_width, self.image_height)
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    def requires_gut(self) -> bool:
        """Non-pinhole or distorted cameras require the GUT path (trainer.cpp:586-597)."""
        return (
            self.camera_model_type != CameraModelType.PINHOLE
            or np.any(self.radial_distortion != 0)
            or np.any(self.tangential_distortion != 0)
        )


def resolve_image_size(
    cam_w: int, cam_h: int, resize_factor: int = -1, max_width: int = 3840
) -> tuple[int, int]:
    """Loaded image size given resize_factor / max_width (image_io.cpp:114-200 semantics).

    Integer-factor box resample first, then a long-side cap preserving aspect.
    """
    w, h = cam_w, cam_h
    if resize_factor and resize_factor > 1:
        w, h = w // resize_factor, h // resize_factor
    long_side = max(w, h)
    if max_width > 0 and long_side > max_width:
        scale = max_width / long_side
        w, h = int(round(w * scale)), int(round(h * scale))
    return w, h
