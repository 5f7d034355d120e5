"""The work a frame or a train step needs, counted from the benchmark's own reference
(pairs, instances, visible Gaussians, pixels), never read from the program, and the
card's published peaks.

Pair counts (the reference's `Frame.render`): `used` pairs pass the alpha test before
their pixel stops; `stops` pixels end on a stopping pair; `needed` (tile, Gaussian)
instances have at least one used pair; `rect` instances are the visible Gaussians'
opacity-aware tile rects (what the expansion must emit); `visible` Gaussians pass the
projection's culls. The operation counts per unit were first written for
`chip_smoke.py`'s kernel table (K2 21 a needed pair, K3 47 more a used pair); the rest
are counted from `sb_reference.py`'s arithmetic.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and FP32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

BLEND_FWD_OPS = 21  # a pair the data needs (used or stopping): sigma, exp, alpha, T, rgb
BLEND_BWD_OPS = 47  # more for a used pair: the replayed weights' gradients (K3)
PROJECT_FWD_OPS = 340  # a visible Gaussian: transform, EWA covariance, conic, rect, SH 3
PROJECT_BWD_OPS = 680  # its backward (twice the forward)
LOSS_OPS_PER_PIXEL = 1550  # L1 and SSIM (five 11+11-tap blurs of 3 channels) both ways
REG_OPS_PER_SLOT = 20  # the scale and opacity regularisers, both ways
NOISE_OPS_PER_SLOT = 95  # the MCMC noise: rotation, R S^2 R^T eps, the opacity gate
ADAM_OPS_PER_FLOAT = 14  # two moments, bias corrections, sqrt, divide, update
FLOATS_PER_SLOT = 59  # means 3, sh0 3, shN 45, scales 3, rotation 4, opacity 1
COMPOSE_OPS_PER_PIXEL = 3  # the background term
# 3DGUT (counted from sb_reference's project_ut, gut_features, gut_rays and the ray blend)
GUT_FWD_OPS = 49  # a needed pair: M d, normalise, cross product, power, exp, alpha, T, rgb
GUT_BWD_OPS = 83  # more for a used pair (K6)
UT_PROJECT_OPS = 350  # seven sigma points through the distorted camera, mean, covariance
GUT_FEATURE_FWD_OPS = 210  # M = S^-1 R^T, M (o - mean), opacity, SH 3
GUT_FEATURE_BWD_OPS = 420
GUT_RAY_OPS_PER_PIXEL = 330  # 20 undistortion steps, normalise, rotate
RAY_BYTES = 4 * 4  # a pixel's ray direction
GUT_FEATURE_BYTES = 16 * 4  # M, M (o - mean), opacity, colour
GUT_GRAD_ROW_BYTES = 16 * 4

# bytes of one instance's blend inputs: mean and conic (5 values) and opacity and
# colour (4); the bf16 pack holds the first five as hi/lo pairs
FEATURE_BYTES = {"f32": 9 * 4, "bf16_pack": (10 + 4) * 2}
GRAD_ROW_BYTES = 9 * 4  # an instance's gradient row
PIXEL_OUT_BYTES = 4 * 4  # rgb and transmittance
TILE_BOUNDS_BYTES = 8  # a tile's segment start and count


def blend_fwd(work: dict, features: str) -> tuple[float, float]:
    """(operations, bytes) the blend forward needs."""
    ops = BLEND_FWD_OPS * (work["used"] + work["stops"])
    nbytes = (work["needed"] * FEATURE_BYTES[features] + work["pixels"] * PIXEL_OUT_BYTES
              + work["tiles"] * TILE_BOUNDS_BYTES)
    return ops, nbytes


def blend_bwd(work: dict, features: str) -> tuple[float, float]:
    """(operations, bytes) the blend backward needs: the forward's pairs again, the used
    pairs' gradients, the image gradient in and one gradient row per instance out."""
    ops = BLEND_FWD_OPS * (work["used"] + work["stops"]) + BLEND_BWD_OPS * work["used"]
    nbytes = (work["needed"] * (FEATURE_BYTES[features] + GRAD_ROW_BYTES)
              + work["pixels"] * PIXEL_OUT_BYTES + work["tiles"] * TILE_BOUNDS_BYTES)
    return ops, nbytes


def gut_fwd(work: dict) -> tuple[float, float]:
    """(operations, bytes) the ray blend forward needs: the blend's with a ray a pixel
    read and 3DGUT's per-pair response."""
    ops = GUT_FWD_OPS * (work["used"] + work["stops"])
    nbytes = (work["needed"] * GUT_FEATURE_BYTES
              + work["pixels"] * (PIXEL_OUT_BYTES + RAY_BYTES)
              + work["tiles"] * TILE_BOUNDS_BYTES)
    return ops, nbytes


def gut_bwd(work: dict) -> tuple[float, float]:
    """(operations, bytes) the ray blend backward needs."""
    ops = GUT_FWD_OPS * (work["used"] + work["stops"]) + GUT_BWD_OPS * work["used"]
    nbytes = (work["needed"] * (GUT_FEATURE_BYTES + GUT_GRAD_ROW_BYTES)
              + work["pixels"] * (PIXEL_OUT_BYTES + RAY_BYTES)
              + work["tiles"] * TILE_BOUNDS_BYTES)
    return ops, nbytes


def expand(work: dict) -> tuple[float, float]:
    """(operations, bytes) of the instance expansion: a visible Gaussian's 12 table
    values in, 13 values out for each instance of its rect."""
    return 0.0, 4.0 * (12 * work["visible"] + 13 * work["rect"])


def train_step_ops(work: dict) -> float:
    """FP32 operations of the steps `work` counts: the blend both ways (the backward
    replays the forward's pairs), the projection both ways, the loss, the regularisers,
    the MCMC noise and Adam; through 3DGUT the UT projection (no backward), the ray
    blend's inputs both ways and the pixel rays."""
    pairs = work["used"] + work["stops"]
    if work.get("gut"):
        blend = GUT_FWD_OPS * 2 * pairs + GUT_BWD_OPS * work["used"]
        per_gaussian = UT_PROJECT_OPS + GUT_FEATURE_FWD_OPS + GUT_FEATURE_BWD_OPS
        per_pixel = LOSS_OPS_PER_PIXEL + GUT_RAY_OPS_PER_PIXEL
    else:
        blend = BLEND_FWD_OPS * 2 * pairs + BLEND_BWD_OPS * work["used"]
        per_gaussian = PROJECT_FWD_OPS + PROJECT_BWD_OPS
        per_pixel = LOSS_OPS_PER_PIXEL
    return (blend + per_gaussian * work["visible"] + per_pixel * work["pixels"]
            + (REG_OPS_PER_SLOT + NOISE_OPS_PER_SLOT + ADAM_OPS_PER_FLOAT * FLOATS_PER_SLOT)
            * work["alive"])


def frame_ops(work: dict) -> float:
    """FP32 operations of the frames `work` counts."""
    return (BLEND_FWD_OPS * (work["used"] + work["stops"]) + PROJECT_FWD_OPS * work["visible"]
            + COMPOSE_OPS_PER_PIXEL * work["pixels"])


def roofline_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """The least time the card could take (operations or bytes at its peak, whichever
    is longer) as a share of `seconds`, in percent; None without a time."""
    if seconds <= 0:
        return None
    return 100.0 * max(ops / PEAK_F32_S, nbytes / PEAK_BYTES_S) / seconds
