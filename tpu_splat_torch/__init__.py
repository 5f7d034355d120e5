"""tpu_splat_torch — the PyTorch / CUDA port of tpu_splat for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on the ported path
is a CUDA C++ kernel written for sm_90a (`csrc/`), built at first use and bound with
ctypes (`ops/cuda/build.py`). Each kernel keeps a plain PyTorch version beside it, which
is what runs when the tensors lie on the CPU.

Entry points run on the card unless the caller asks for the CPU (`device="cpu"`); without
a card they raise instead of falling back.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
