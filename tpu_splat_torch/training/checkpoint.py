"""Full training-state checkpoint/resume, port of `tpu_splat/training/checkpoint.py`.

The complete TrainState (splat params, Adam moments and step counts, iteration,
densification info, component states) round-trips through a single .npz, plus a JSON
sidecar with the static metadata. The layout is the JAX package's: the .npz keys are the
ones its `_flatten_with_paths` gives for the same state ("splat/means",
"adam/step_count/means", "pose_params/layers/0/w", "admm/u", ...) and the sidecar has its
`meta` fields, so each package reads the other's files.

The random stream: the port stores its `torch.Generator`'s state under a key of its own
(`TORCH_RNG_KEY`, with the generator's device type in the sidecar) and restores it bit for
bit; it also writes `__rng_key_data__` (a threefry key derived from the generator's
seed) so that the JAX package can load the file. A JAX key cannot become a torch stream:
loading a checkpoint that the JAX package wrote (or one written on another device type)
seeds the generator from the key data, and logs that it did.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.splat import PARAM_FIELDS, SplatState
from ..device import resolve_device
from ..utils.log import get_logger
from .optim import AdamState
from .sparsity import ADMMState
from .train_step import AuxOptState, TrainState

log = get_logger(__name__)

TORCH_RNG_KEY = "__torch_rng_state__"
JAX_RNG_KEY = "__rng_key_data__"


def _flatten(prefix: str, obj, out: dict) -> None:
    """The JAX package's key paths: dataclass fields and dict keys by name, list items by
    index, joined with '/'; Python ints as int32 scalars."""
    if obj is None:
        return
    if isinstance(obj, (dict, list)):
        items = obj.items() if isinstance(obj, dict) else enumerate(obj)
        for k, v in items:
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flatten(f"{prefix}/{f.name}" if prefix else f.name, getattr(obj, f.name), out)
    elif isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().cpu().numpy()
    elif isinstance(obj, int):
        out[prefix] = np.int32(obj)


def state_arrays(ts: TrainState) -> dict[str, np.ndarray]:
    """The checkpoint's arrays of `ts`, without the random stream."""
    out: dict[str, np.ndarray] = {}
    splat = {k: getattr(ts.splat, k) for k in PARAM_FIELDS + ("alive",)}
    _flatten("splat", splat, out)
    _flatten("adam", ts.adam, out)
    for f in dataclasses.fields(ts):
        if f.name not in ("splat", "adam", "rng"):
            _flatten(f.name, getattr(ts, f.name), out)
    return out


def save_checkpoint(path: str | Path, ts: TrainState, extra: Optional[dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = state_arrays(ts)
    arrays[TORCH_RNG_KEY] = ts.rng.get_state().numpy()
    arrays[JAX_RNG_KEY] = np.array([0, ts.rng.initial_seed() & 0xFFFFFFFF], np.uint32)
    meta = {
        "max_sh_degree": ts.splat.max_sh_degree,
        "scene_scale": ts.splat.scene_scale,
        "capacity": int(ts.splat.capacity),
        "has_bilateral": ts.bilateral_grids is not None,
        "has_pose": ts.pose_params is not None,
        "pose_n_layers": len(ts.pose_params["layers"])
        if (ts.pose_params is not None and "layers" in ts.pose_params)
        else 0,
        "has_admm": ts.admm is not None,
        "extra": extra or {},
        "torch_rng_device": ts.device.type,
    }
    np.savez_compressed(path, **arrays)
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=2))


def load_checkpoint(path: str | Path,
                    device: str | torch.device | None = None) -> tuple[TrainState, dict]:
    """Rebuild the TrainState on `device` (the CUDA card when None; raises without one);
    returns (state, extra)."""
    dev = resolve_device(device)
    path = Path(path)
    meta = json.loads(Path(str(path) + ".json").read_text())
    data = dict(np.load(path, allow_pickle=False))

    def t(key):
        return torch.as_tensor(data[key], device=dev)

    def sub(prefix):
        """The subtree of keys under `prefix` as nested dicts (lists where keys are
        indices)."""
        tree: dict = {}
        for key in data:
            if key.startswith(prefix + "/"):
                node, parts = tree, key[len(prefix) + 1:].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = t(key)

        def lists(node):
            if not isinstance(node, dict):
                return node
            if node and all(k.isdigit() for k in node):
                return [lists(node[str(i)]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}

        return lists(tree)

    splat = SplatState(max_sh_degree=meta["max_sh_degree"], scene_scale=meta["scene_scale"],
                       **{k: t(f"splat/{k}") for k in PARAM_FIELDS + ("alive",)})
    adam = sub("adam")
    adam = AdamState(exp_avg=adam["exp_avg"], exp_avg_sq=adam["exp_avg_sq"],
                     step_count={k: int(v) for k, v in adam["step_count"].items()})

    def aux_opt(prefix):
        d = sub(prefix)
        return AuxOptState(m=d["m"], v=d["v"], count=int(d["count"]))

    rng = torch.Generator(device=dev)
    if TORCH_RNG_KEY in data and meta.get("torch_rng_device") == dev.type:
        rng.set_state(torch.from_numpy(data[TORCH_RNG_KEY]))
    else:
        key = data[JAX_RNG_KEY].astype(np.uint64).reshape(-1)
        seed = int(key[-1] | (key[0] << np.uint64(32)))
        rng.manual_seed(seed)
        log.info("checkpoint %s holds no torch generator state for %s: the generator is "
                 "seeded from its JAX key data (seed %d)", path, dev.type, seed)
    ts = TrainState(
        splat=splat, adam=adam, rng=rng, iteration=int(data["iteration"]),
        dens_count=t("dens_count"), dens_grad2d=t("dens_grad2d"),
        bilateral_grids=t("bilateral_grids") if meta["has_bilateral"] else None,
        bilateral_opt=aux_opt("bilateral_opt") if meta["has_bilateral"] else None,
        pose_params=sub("pose_params") if meta["has_pose"] else None,
        pose_opt=aux_opt("pose_opt") if meta["has_pose"] else None,
        admm=ADMMState(u=t("admm/u"), z=t("admm/z")) if meta["has_admm"] else None,
    )
    return ts, meta.get("extra", {})
