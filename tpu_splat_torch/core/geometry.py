"""Geometry primitives: EuclideanTransform and BoundingBox (port of `tpu_splat/core/geometry.py`).

Reference: src/geometry/euclidean_transform.{hpp,cpp} (quat + translation with
compose/inverse/mat4) and include/geometry/bounding_box.hpp (axis-aligned box carrying a
world-to-box transform, used for crop-box rendering and SplatData::crop_by_cropbox,
src/core/splat_data.cpp:615-719).

The transforms and boxes are small host objects and stay numpy, float32, with the JAX
version's arithmetic. `crop_splat_by_box` tests the state's means in torch, on the state's
device, and returns a state whose alive mask is `alive & inside`: capacity unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch


def quat_multiply(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], np.float32)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


@dataclass
class EuclideanTransform:
    """Rigid transform as unit quaternion (wxyz) + translation
    (include/geometry/euclidean_transform.hpp:14)."""

    rotation: np.ndarray = field(default_factory=lambda: np.array([1, 0, 0, 0], np.float32))
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def __post_init__(self):
        self.rotation = np.asarray(self.rotation, np.float32)
        self.rotation = self.rotation / np.linalg.norm(self.rotation)
        self.translation = np.asarray(self.translation, np.float32)

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "EuclideanTransform":
        from scipy.spatial.transform import Rotation

        m = np.asarray(m, np.float64)
        x, y, z, w = Rotation.from_matrix(m[:3, :3]).as_quat()
        return cls(np.array([w, x, y, z], np.float32), m[:3, 3].astype(np.float32))

    def to_matrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_matrix(self.rotation)
        m[:3, 3] = self.translation
        return m

    def compose(self, other: "EuclideanTransform") -> "EuclideanTransform":
        """self * other (apply `other` first)."""
        r = quat_multiply(self.rotation, other.rotation)
        t = quat_to_matrix(self.rotation) @ other.translation + self.translation
        return EuclideanTransform(r, t)

    def inverse(self) -> "EuclideanTransform":
        rinv = self.rotation * np.array([1, -1, -1, -1], np.float32)
        tinv = -(quat_to_matrix(rinv) @ self.translation)
        return EuclideanTransform(rinv, tinv)

    def apply(self, points: np.ndarray) -> np.ndarray:
        return points @ quat_to_matrix(self.rotation).T + self.translation


@dataclass
class BoundingBox:
    """Axis-aligned bounds in box space + a world-to-box transform (an OBB in world space,
    include/geometry/bounding_box.hpp:13)."""

    min_bounds: np.ndarray = field(default_factory=lambda: np.full(3, -1.0, np.float32))
    max_bounds: np.ndarray = field(default_factory=lambda: np.full(3, 1.0, np.float32))
    world2bbox: EuclideanTransform = field(default_factory=EuclideanTransform)

    def __post_init__(self):
        self.min_bounds = np.asarray(self.min_bounds, np.float32)
        self.max_bounds = np.asarray(self.max_bounds, np.float32)

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.min_bounds + self.max_bounds)

    @property
    def size(self) -> np.ndarray:
        return self.max_bounds - self.min_bounds

    def contains(self, world_points: torch.Tensor) -> torch.Tensor:
        """Boolean mask of world points [N, 3] inside the oriented box, computed on the
        points' device (SplatData::crop_by_cropbox semantics, splat_data.cpp:615-719)."""
        dev = world_points.device

        def const(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        rot = const(quat_to_matrix(self.world2bbox.rotation))
        local = world_points.float() @ rot.T + const(self.world2bbox.translation)
        return torch.all((local >= const(self.min_bounds)) & (local <= const(self.max_bounds)),
                         dim=1)


def crop_splat_by_box(splat, box: BoundingBox):
    """Return a SplatState whose alive mask keeps only gaussians inside the box
    (reference: SplatData::crop_by_cropbox; here a pure mask update — capacity unchanged)."""
    return dataclasses.replace(splat, alive=splat.alive & box.contains(splat.means))
