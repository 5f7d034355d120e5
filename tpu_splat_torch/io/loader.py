"""Loader facade: the Gaussian-PLY branch of the JAX package's `io/loader.py::load`.

SOG models and the training inputs (COLMAP, Blender transforms, point-cloud PLYs) are
not ported yet; they raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from . import ply


@dataclass
class LoadResult:
    """A ready splat model: raw parameter arrays as written by `save_splat_ply`."""

    splat_params: Optional[dict] = None
    loader_used: str = ""


def load(path: str | Path) -> LoadResult:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    if path.is_file() and path.suffix.lower() == ".ply" and ply.is_gaussian_ply(path):
        return LoadResult(splat_params=ply.load_splat_ply(path), loader_used="ply")
    raise ValueError(f"{path} is not a Gaussian PLY (the only model format ported so far)")
