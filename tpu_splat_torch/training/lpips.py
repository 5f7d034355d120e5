"""LPIPS perceptual metric (VGG16 backbone + linear heads), port of
`tpu_splat/training/lpips.py`.

Reference: the evaluator loads a TorchScript VGG-LPIPS from `weights/lpips_vgg.pt`
(src/training/metrics/metrics.hpp:54-67); that file is not shipped. Here the standard
LPIPS-VGG architecture (Zhang et al. 2018) runs as an `nn.Module` on the render's device,
with weights from the same .npz the JAX package reads (converted once from the official
torch checkpoint by `convert_torch_lpips`). Without a weights file the metric is None.

Pipeline (lpips.LPIPS(net='vgg') semantics):
  x in [0,1] -> scale to [-1,1] -> (x - shift)/scale with ImageNet-ish constants ->
  VGG16 features at relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 -> unit-normalize each
  channel vector -> squared diff -> 1x1 conv (linear head) -> spatial mean -> sum layers.

The convolutions are `torch.nn.functional.conv2d`: the JAX package computes them with
`lax.conv_general_dilated`, outside any Pallas kernel. TF32 stays off (`device.py`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# VGG16 conv plan: (out_channels, n_convs) per block; features tapped after each block
VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPSVGG(torch.nn.Module):
    """LPIPS-VGG from the JAX package's parameter dict (conv{i}_w [O,I,3,3], conv{i}_b [O],
    lin{i}_w [1,C,1,1]) as buffers."""

    def __init__(self, params: dict[str, np.ndarray]):
        super().__init__()
        n_convs = sum(n for _, n in VGG_BLOCKS)
        for i in range(n_convs):
            self.register_buffer(f"conv{i}_w", torch.as_tensor(np.asarray(params[f"conv{i}_w"],
                                                                          np.float32)))
            self.register_buffer(f"conv{i}_b", torch.as_tensor(np.asarray(params[f"conv{i}_b"],
                                                                          np.float32)))
        for i in range(len(VGG_BLOCKS)):
            self.register_buffer(f"lin{i}_w", torch.as_tensor(np.asarray(params[f"lin{i}_w"],
                                                                         np.float32)))
        self.register_buffer("shift", torch.as_tensor(SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.as_tensor(SCALE).reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [N,3,H,W] normalized; returns the five tap activations."""
        feats, h, li = [], x, 0
        for bi, (_, n_convs) in enumerate(VGG_BLOCKS):
            for _ in range(n_convs):
                w, b = getattr(self, f"conv{li}_w"), getattr(self, f"conv{li}_b")
                h = torch.relu(F.conv2d(h, w, b, padding=1))
                li += 1
            feats.append(h)
            if bi < len(VGG_BLOCKS) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b [N,3,H,W] in [0,1] -> the LPIPS distance summed over the five taps (mean
        over the batch and the pixels)."""
        fa = self.features((2.0 * a - 1.0 - self.shift) / self.scale)
        fb = self.features((2.0 * b - 1.0 - self.shift) / self.scale)
        total = torch.zeros((), dtype=a.dtype, device=a.device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.clamp_min(torch.linalg.vector_norm(xa, dim=1, keepdim=True), 1e-10)
            nb = xb / torch.clamp_min(torch.linalg.vector_norm(xb, dim=1, keepdim=True), 1e-10)
            d = (na - nb) ** 2  # [N,C,H,W]
            total = total + torch.mean(torch.sum(d * getattr(self, f"lin{i}_w"), dim=1))
        return total


class LPIPSTorch:
    """The port's counterpart of `LPIPSJax`: LPIPS-VGG from an .npz on `device` (the CUDA
    card when None); `available` is False without a weights file. A file that exists
    but does not load raises."""

    def __init__(self, weights_path: str | Path = "weights/lpips_vgg.npz",
                 device: str | torch.device | None = None):
        self.model: Optional[LPIPSVGG] = None
        p = Path(weights_path)
        if p.exists():
            with np.load(p, allow_pickle=False) as data:
                params = {k: data[k] for k in data.files}
            self.model = LPIPSVGG(params).to(resolve_device(device)).eval()

    @property
    def available(self) -> bool:
        return self.model is not None

    @torch.no_grad()
    def __call__(self, a, b) -> Optional[float]:
        """a, b [3,H,W] in [0,1] (tensors or numpy arrays)."""
        if self.model is None:
            return None
        dev = self.model.shift.device
        ta = torch.as_tensor(np.asarray(a, np.float32) if isinstance(a, np.ndarray) else a,
                             dtype=torch.float32, device=dev)
        tb = torch.as_tensor(np.asarray(b, np.float32) if isinstance(b, np.ndarray) else b,
                             dtype=torch.float32, device=dev)
        return float(self.model(ta[None], tb[None]))


def convert_torch_lpips(torch_lpips_state: dict, out_path: str | Path) -> None:
    """One-time converter: official `lpips.LPIPS(net='vgg')` state_dict -> npz.

    Run wherever torch+lpips are installed:
        import lpips
        m = lpips.LPIPS(net='vgg')
        convert_torch_lpips({k: v.numpy() for k, v in m.state_dict().items()}, out)
    """
    # lpips's vgg is split into slice1..slice5; gather conv weights in order
    convs = []
    for k in sorted(torch_lpips_state):
        if k.startswith("net.slice") and k.endswith(".weight") and torch_lpips_state[k].ndim == 4:
            convs.append(k[: -len(".weight")])

    def slice_order(name):
        parts = name.split(".")
        return (int(parts[1][len("slice"):]), int(parts[2]))

    convs.sort(key=slice_order)
    out = {}
    for i, base in enumerate(convs):
        out[f"conv{i}_w"] = np.asarray(torch_lpips_state[base + ".weight"])
        out[f"conv{i}_b"] = np.asarray(torch_lpips_state[base + ".bias"])
    for i in range(5):
        out[f"lin{i}_w"] = np.asarray(torch_lpips_state[f"lin{i}.model.1.weight"]).reshape(
            1, -1, 1, 1
        )
    np.savez_compressed(out_path, **out)


def random_params(seed: int = 0) -> dict[str, np.ndarray]:
    """Random-weight LPIPS for tests (architecture exercise only); the JAX package's draws
    from the same seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    params = {}
    li = 0
    in_ch = 3
    for ch, n_convs in VGG_BLOCKS:
        for _ in range(n_convs):
            params[f"conv{li}_w"] = rng.normal(0, 0.05, (ch, in_ch, 3, 3)).astype(np.float32)
            params[f"conv{li}_b"] = np.zeros((ch,), np.float32)
            in_ch = ch
            li += 1
    for i, (ch, _) in enumerate(VGG_BLOCKS):
        params[f"lin{i}_w"] = np.abs(rng.normal(0, 0.01, (1, ch, 1, 1))).astype(np.float32)
    return params
