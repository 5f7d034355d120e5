"""Camera pose optimization modules, port of `tpu_splat/training/poseopt.py` (reference:
src/training/components/poseopt.{hpp,cpp}).

Two learned corrections to the world-to-camera transform, optimized jointly with the scene
by a separate Adam (lr 1e-5, trainer.cpp:384-386):

  * direct: per-camera 9D embedding (3 translation + 6D rotation), zero-init
    (poseopt.cpp:22-44).
  * mlp: per-camera width-64 embedding -> depth-2 ReLU MLP -> 9D, last layer zero-init
    (3R-GS; poseopt.cpp:45-75).

forward(w2c, cam_idx) returns w2c @ delta where delta = [[R(rot6d+id6), t], [0, 1]]
(poseopt.cpp:31-44). Incompatible with --gut in the reference (trainer.cpp:366-389).
Parameters are the JAX package's pytree as nested dicts and lists of tensors
({"embeddings": [N, D], "layers": [{"w", "b"}, ...]}), so a checkpoint has the same keys
in both packages. The MLP's random init draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch


def rotation_6d_to_matrix(rot6d: torch.Tensor) -> torch.Tensor:
    """6D rotation -> 3x3 via Gram-Schmidt (poseopt.cpp:12-20). rot6d [..., 6]."""
    a1 = rot6d[..., :3]
    a2 = rot6d[..., 3:]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1, dim=-1, keepdim=True), 1e-12)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp_min(torch.linalg.norm(a2p, dim=-1, keepdim=True), 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def init_direct(num_cameras: int, device: torch.device | str = "cpu") -> dict:
    """Zero-init per-camera 9D embeddings (poseopt.cpp:28)."""
    return {"embeddings": torch.zeros((num_cameras, 9), dtype=torch.float32, device=device)}


def init_mlp(generator: torch.Generator, num_cameras: int, width: int = 64, depth: int = 2,
             device: torch.device | str = "cpu") -> dict:
    """Zero-init embeddings + MLP; last layer zero-init (poseopt.cpp:47-62). The hidden
    layers' weights and biases are U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch Linear's
    default, drawn from `generator` (on `device`)."""
    params = {"embeddings": torch.zeros((num_cameras, width), dtype=torch.float32,
                                        device=device), "layers": []}
    bound = 1.0 / math.sqrt(width)

    def uniform(shape):
        u = torch.rand(shape, dtype=torch.float32, device=device, generator=generator)
        return u * (2.0 * bound) - bound

    for _ in range(depth):
        params["layers"].append({"w": uniform((width, width)), "b": uniform((width,))})
    params["layers"].append({"w": torch.zeros((width, 9), dtype=torch.float32, device=device),
                             "b": torch.zeros((9,), dtype=torch.float32, device=device)})
    return params


def _delta_to_transform(delta9: torch.Tensor) -> torch.Tensor:
    """9D (3 trans + 6D rot) -> 4x4 correction matrix (poseopt.cpp:33-44)."""
    t = delta9[:3]
    # the 6D identity [1, 0, 0, 0, 1, 0] and the bottom row [0, 0, 0, 1] are rows of an
    # identity built on the device: no host-to-device copy in the step
    eye = torch.eye(4, dtype=delta9.dtype, device=delta9.device)
    r = rotation_6d_to_matrix(delta9[3:] + eye[:2, :3].reshape(6))
    top = torch.cat([r, t[:, None]], dim=1)  # [3, 4]
    return torch.cat([top, eye[3:]], dim=0)


def apply_direct(params: dict, w2c: torch.Tensor, cam_idx: int) -> torch.Tensor:
    """w2c [4,4] x learned per-camera correction (poseopt.cpp:31-44)."""
    return w2c @ _delta_to_transform(params["embeddings"][cam_idx])


def apply_mlp(params: dict, w2c: torch.Tensor, cam_idx: int) -> torch.Tensor:
    """Embedding -> MLP -> 9D correction (poseopt.cpp:64-75)."""
    h = params["embeddings"][cam_idx]
    for layer in params["layers"][:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    last = params["layers"][-1]
    return w2c @ _delta_to_transform(h @ last["w"] + last["b"])


def apply(mode: str, params: dict | None, w2c: torch.Tensor, cam_idx: int) -> torch.Tensor:
    if mode == "none" or params is None:
        return w2c
    if mode == "direct":
        return apply_direct(params, w2c, cam_idx)
    if mode == "mlp":
        return apply_mlp(params, w2c, cam_idx)
    raise ValueError(f"unknown pose optimization mode {mode!r}")


def init(mode: str, generator: torch.Generator, num_cameras: int,
         device: torch.device | str = "cpu") -> dict | None:
    if mode == "none":
        return None
    if mode == "direct":
        return init_direct(num_cameras, device)
    if mode == "mlp":
        return init_mlp(generator, num_cameras, device=device)
    raise ValueError(f"unknown pose optimization mode {mode!r}")
