"""Loader facade: format detection + dispatch (port of `tpu_splat/io/loader.py`).

Detects COLMAP / Blender-transforms / Gaussian-PLY / point-cloud-PLY / SOG and returns
either a splat parameter dict (a model to view) or a LoadedScene (cameras + SfM points to
train from).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.camera import Camera
from . import colmap, ply, sog, transforms


@dataclass
class LoadedScene:
    cameras: list[Camera]
    points: np.ndarray  # [N,3]
    colors: np.ndarray  # [N,3] in [0,1]
    scene_center: np.ndarray  # [3]


@dataclass
class LoadResult:
    """Either a ready splat model (PLY) or a trainable scene (COLMAP/Blender)."""

    scene: Optional[LoadedScene] = None
    splat_params: Optional[dict] = None
    loader_used: str = ""
    warnings: list[str] = field(default_factory=list)


def load(path: str | Path, images_folder: str = "images", rc: bool = False) -> LoadResult:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))

    if path.is_file() and path.suffix.lower() == ".ply":
        if ply.is_gaussian_ply(path):
            return LoadResult(splat_params=ply.load_splat_ply(path), loader_used="ply")
        pts, cols = ply.load_pointcloud_ply(path)
        scene = LoadedScene(cameras=[], points=pts, colors=cols,
                            scene_center=pts.mean(axis=0).astype(np.float32))
        return LoadResult(scene=scene, loader_used="ply_pointcloud")

    if path.is_file() and path.suffix.lower() == ".sog" or (path / "meta.json").exists():
        return LoadResult(splat_params=sog.load_sog(path), loader_used="sog")

    if colmap.is_colmap_dataset(path):
        cameras, pts, cols, center = colmap.load_colmap(path, images_folder, rc)
        return LoadResult(
            scene=LoadedScene(cameras=cameras, points=pts, colors=cols, scene_center=center),
            loader_used="colmap",
        )

    if transforms.is_transforms_dataset(path):
        cameras, center = transforms.load_transforms(path)
        # Blender datasets have no SfM points; the trainer falls back to random init
        return LoadResult(
            scene=LoadedScene(
                cameras=cameras,
                points=np.zeros((0, 3), np.float32),
                colors=np.zeros((0, 3), np.float32),
                scene_center=center,
            ),
            loader_used="transforms",
        )

    raise ValueError(f"Unrecognized dataset format at {path}")
