"""Device resolution and float32 matmul precision for the port.

The JAX reference runs its float32 math in full float32, so TF32 is switched off for
both cuBLAS matmuls and cuDNN convolutions (the latter defaults to TF32 on Ampere+).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card; the CPU runs only when asked for by name.

    Raises when a CUDA device is requested (explicitly or by default) and none is
    present — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) to run "
            "on the CPU"
        )
    return dev
