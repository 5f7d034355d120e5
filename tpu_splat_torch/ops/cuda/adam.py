"""Fused Adam: one launch of `csrc/adam.cu` updates every leaf a train step trains.

`adam_kernel` is what `training/optim.py::adam_step` runs on a CUDA device; the chain of
elementwise ops there (`optim.py::_adam_plain`) is its plain version. The kernel repeats the
chain's operations in their order, so on the card the two agree bit for bit. Each leaf's
learning rate and the reciprocals of its bias corrections are launch arguments, computed
here in float32 as PyTorch computes the scalars of the chain's ops; nothing is copied from
the host to the device, so the wrapper does not wait for the stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import ADAM_MAX_LEAVES, AdamArgs, check, count_launch, kernel, require_cuda


def leaf_scalars(lr: float, bc1: float, bc2: float) -> tuple[float, float, float]:
    """The float32 scalars the chain multiplies by: the learning rate, and the reciprocal of
    each bias correction (PyTorch's CUDA division of a tensor by a Python scalar multiplies
    by `1.0f / (float)bc`, computed on the host)."""
    one = np.float32(1.0)
    return (float(np.float32(lr)), float(one / np.float32(bc1)), float(one / np.float32(bc2)))


@torch.no_grad()
def adam_kernel(params, grads, exp_avg, exp_avg_sq, lrs, bc1s, bc2s):
    """One Adam step of up to ADAM_MAX_LEAVES leaves in one launch: leaf i's parameters,
    gradient and moments params[i], grads[i], exp_avg[i], exp_avg_sq[i] (float32,
    contiguous, of one shape, all on one card), its learning rate lrs[i] and bias
    corrections bc1s[i], bc2s[i]. -> (new params, new exp_avg, new exp_avg_sq), lists in
    the leaves' order, new tensors: the inputs are left as they are."""
    leaves = list(zip(params, grads, exp_avg, exp_avg_sq))
    if not (len(leaves) == len(params) == len(grads) == len(exp_avg) == len(exp_avg_sq)
            == len(lrs) == len(bc1s) == len(bc2s)):
        raise ValueError("adam_kernel: one gradient, two moments, a learning rate and two "
                         "bias corrections a leaf expected")
    if not 1 <= len(leaves) <= ADAM_MAX_LEAVES:
        raise ValueError(f"adam_kernel takes 1 to {ADAM_MAX_LEAVES} leaves, got {len(leaves)}")
    named = {f"leaf {i}: {name}": x for i, leaf in enumerate(leaves)
             for name, x in zip(("param", "grad", "exp_avg", "exp_avg_sq"), leaf)}
    for name, x in named.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    for i, (p, *rest) in enumerate(leaves):
        for name, x in zip(("grad", "exp_avg", "exp_avg_sq"), rest):
            if x.shape != p.shape:
                raise ValueError(f"leaf {i}: {name} of shape {tuple(x.shape)}, the "
                                 f"parameter's is {tuple(p.shape)}")
    ref = leaves[0][0]
    require_cuda(ref, **named)  # contiguous, on the first parameter's card
    outs = [tuple(torch.empty_like(p) for _ in range(3)) for p, *_ in leaves]
    args = AdamArgs(n_leaves=len(leaves))
    for d, leaf, out, lr, bc1, bc2 in zip(args.leaf, leaves, outs, lrs, bc1s, bc2s):
        ptrs = [x.data_ptr() for x in (*leaf, *out)]
        d.p, d.g, d.m, d.v, d.p_out, d.m_out, d.v_out = ptrs
        d.n = leaf[0].numel()
        d.lr, d.inv_bc1, d.inv_bc2 = leaf_scalars(lr, bc1, bc2)
        d.vec = int(all(ptr % 16 == 0 for ptr in ptrs))
    err = kernel("adam")(args, torch.cuda.current_stream(ref.device).cuda_stream)
    check(err, "adam")
    count_launch(adam_kernel)
    return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]


adam_kernel.launches = 0
