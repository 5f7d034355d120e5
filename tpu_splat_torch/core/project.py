"""Project management (port of `tpu_splat/core/project.py`): versioned JSON project files + lock files.

Reference: src/project/project.cpp (~800 LoC managing `.ls` files, temp projects, version
migration, output PLY records — include/project/project.hpp:39-188). Same capability,
JSON-native: a project records the dataset, parameters and produced artifacts so runs are
resumable and auditable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

PROJECT_VERSION = 2
PROJECT_SUFFIX = ".ls"  # kept for reference-ecosystem compatibility
LOCK_SUFFIX = ".lock"


@dataclass
class PlyRecord:
    """An output artifact record (project.hpp Ply data)."""

    name: str
    path: str
    iteration: int = -1
    timestamp: float = 0.0


@dataclass
class Project:
    path: Path
    version: int = PROJECT_VERSION
    name: str = ""
    data_path: str = ""
    output_path: str = ""
    is_temporary: bool = False
    created: float = field(default_factory=time.time)
    updated: float = field(default_factory=time.time)
    params: dict = field(default_factory=dict)
    plys: list[PlyRecord] = field(default_factory=list)
    checkpoints: list[str] = field(default_factory=list)

    # ------------------------------------------------------------------ persistence

    def save(self) -> None:
        self.updated = time.time()
        obj = dataclasses.asdict(self)
        obj["path"] = str(self.path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps(obj, indent=2))
        os.replace(tmp, self.path)

    @classmethod
    def load(cls, path: str | Path) -> "Project":
        path = Path(path)
        obj = json.loads(path.read_text())
        version = obj.get("version", 1)
        if version > PROJECT_VERSION:
            raise ValueError(f"project version {version} is newer than supported {PROJECT_VERSION}")
        obj = _migrate(obj, version)
        plys = [PlyRecord(**p) for p in obj.pop("plys", [])]
        obj.pop("path", None)
        return cls(path=path, plys=plys, **{k: v for k, v in obj.items() if k in {
            "version", "name", "data_path", "output_path", "is_temporary",
            "created", "updated", "params", "checkpoints"}})

    # ------------------------------------------------------------------------ locking

    @property
    def lock_path(self) -> Path:
        return self.path.with_suffix(self.path.suffix + LOCK_SUFFIX)

    def acquire_lock(self) -> bool:
        """Best-effort exclusive lock (project.cpp lock files). Returns False if held."""
        try:
            fd = os.open(self.lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:  # stale lock from a dead process?
                pid = int(self.lock_path.read_text().strip() or -1)
            except Exception:
                pid = -1
            if pid > 0 and not _pid_alive(pid):
                self.lock_path.unlink(missing_ok=True)
                return self.acquire_lock()
            return False
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        return True

    def release_lock(self) -> None:
        self.lock_path.unlink(missing_ok=True)

    # ------------------------------------------------------------------- bookkeeping

    def add_ply(self, name: str, path: str | Path, iteration: int = -1) -> None:
        self.plys.append(
            PlyRecord(name=name, path=str(path), iteration=iteration, timestamp=time.time())
        )
        self.save()

    def add_checkpoint(self, path: str | Path) -> None:
        self.checkpoints.append(str(path))
        self.save()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _migrate(obj: dict, version: int) -> dict:
    """Version migration scaffolding (project.cpp versioned read)."""
    if version < 2:
        obj.setdefault("checkpoints", [])
        obj["version"] = 2
    return obj


def create_new_project(
    data_path: str, output_path: str, name: str = "", project_path: Optional[str] = None
) -> Project:
    """CreateNewProject (project.hpp:99-188)."""
    out = Path(output_path)
    path = Path(project_path) if project_path else out / f"{name or out.name}{PROJECT_SUFFIX}"
    proj = Project(path=path, name=name or out.name, data_path=str(data_path),
                   output_path=str(output_path))
    proj.save()
    return proj


def create_temp_project(data_path: str = "", output_path: str = "") -> Project:
    """CreateTempNewProject: project in a temp dir, flagged temporary."""
    d = Path(tempfile.mkdtemp(prefix="tpu_splat_proj_"))
    proj = Project(path=d / f"temp{PROJECT_SUFFIX}", name="temp", data_path=str(data_path),
                   output_path=str(output_path or d), is_temporary=True)
    proj.save()
    return proj
