"""The render cells' run: a closed loop of one client over the program's `render_view`.

Set-up makes the seeded scene on the device as the program's `SplatState` (every slot
alive) and the poses: `poses` around the capture's views. The client asks for the next
frame once the last one's image is in host memory, as a viewer does, cycling through the
poses; a frame's latency runs from its request to its image on the host. After the
window a traced run profiles `trace_frames` more frames. The last window frame of each of
`compare_frames` poses, drawn from the seed among those the window rendered, is kept, and
the plain reference renders them again once the window has closed (`compare_frames`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import sb_inputs as inp
import sb_reference as ref
from sb_trace import Capture
from sb_train import ref_camera, sync


def run(cell: dict, seed: int, seconds: float, trace: bool, dev, t_start: float,
        log=print, alter=None, controls=()) -> dict:
    """One run of a render cell. `alter(image)`: a planted fault applied to each frame
    where it is produced (tests only). `controls`: feature precisions of the reference
    to put in the program's place besides (control.py). -> the run's record (see run.py)"""
    from tpu_splat_torch.core.splat import SplatState
    from tpu_splat_torch.render import render_view

    cfg, tr = cell["config"], cell["traffic"]
    w, h, n = cfg["width"], cfg["height"], cfg["n_gaussians"]
    params, alive = inp.make_scene(n, n, w, h, seed, dev)
    state = SplatState(alive=alive, max_sh_degree=3, scene_scale=1.0,
                       **{k: v.contiguous() for k, v in params.items()})
    views = inp.capture_views(seed, cfg["views"], cfg["view_rot"], cfg["view_trans"])
    poses = inp.orbit_poses(seed, views, tr["poses"], tr["pose_rot"], tr["pose_trans"])
    # the compared frames: the last frame of each of the first `compare_frames` poses,
    # in an order drawn from the seed, that the window rendered
    order = np.random.default_rng([int(seed), 6]).permutation(len(poses)).tolist()
    last: dict[int, np.ndarray] = {}

    def frame(i: int) -> np.ndarray:
        out = render_view(state, poses[i % len(poses)], w, h, tr["fov_deg"], device=dev)
        img = out.image.cpu().numpy()
        return img if alter is None else alter(img)

    for i in range(tr["warmup_frames"]):
        frame(i)
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    lat, i = [], 0
    while True:
        r0 = time.perf_counter()
        img = frame(i)
        r1 = time.perf_counter()
        lat.append(r1 - r0)
        last[i % len(poses)] = img
        i += 1
        if r1 - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    record = dict(kind="render", setup_s=setup_s, window_s=window_s, attempted=i, frames=i,
                  latencies_s=lat, trace=None)
    if trace:
        cap = Capture(lambda: sync(dev))
        cap.start()
        for j in range(tr["trace_frames"]):
            frame(i + j)
        record["trace"] = cap.stop()
        record["trace_frames"] = tr["trace_frames"]
    sync(dev)
    record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = {p: last[p] for p in [p for p in order if p in last][:tr["compare_frames"]]}
    del last
    log(f"window closed at {time.perf_counter() - t_start:.1f} s")
    record["checks"] = compare_frames(cell, params, alive, poses, kept, dev)
    log(f"reference compared at {time.perf_counter() - t_start:.1f} s")
    if controls:
        record["controls"] = {}
        for c in controls:
            frames = {p: ref.render(params, alive, camera_of(cell, poses[p], dev), 3,
                                    tr["tile_size"], c)[0] for p in kept}
            record["controls"][c] = compare_frames(cell, params, alive, poses, frames, dev)
    if trace:
        frames = [poses[(i + j) % len(poses)] for j in range(tr["trace_frames"])]
        record["work"] = work_of(cell, params, alive, frames, dev)
    return record


def camera_of(cell: dict, w2c: np.ndarray, dev) -> dict:
    cfg, tr = cell["config"], cell["traffic"]
    return ref_camera(w2c, ref.fov_focal(cfg["width"], tr["fov_deg"]), cfg["width"],
                      cfg["height"], dev)


def compare_frames(cell: dict, params: dict, alive, poses, kept: dict, dev,
                   features: str | None = None) -> dict:
    """The kept frames against the reference's: the worst frame's mean absolute pixel
    difference, and (not compared: single pixels whose alpha sits at the 1/255 threshold
    flip either way under rounding) its largest."""
    tile = cell["traffic"]["tile_size"]
    worst_max = worst_mean = 0.0
    for p, img in sorted(kept.items()):
        want, _ = ref.render(params, alive, camera_of(cell, poses[p], dev), 3, tile,
                             features or cell["features"])
        d = (torch.as_tensor(img, device=dev) - want).abs()
        worst_max, worst_mean = max(worst_max, float(d.max())), max(worst_mean, float(d.mean()))
    return dict(frame_max_abs=worst_max, frame_mean_abs=worst_mean, frames=sorted(kept))


def work_of(cell: dict, params: dict, alive, frames: list, dev) -> dict:
    """The work the traced frames needed, from the reference: pair and instance counts."""
    cfg, tile = cell["config"], cell["traffic"]["tile_size"]
    w, h = cfg["width"], cfg["height"]
    total: dict = {}
    for w2c in frames:
        cam = camera_of(cell, w2c, dev)
        with torch.no_grad():
            proj = ref.project(params, alive, cam, 3, tile)
        _, c = ref.render(params, alive, cam, 3, tile, cell["features"])
        c["visible"] = int(proj["visible"].sum())
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    gw, gh = -(-w // tile), -(-h // tile)
    total.update(steps=len(frames), pixels=len(frames) * w * h,
                 tiles=len(frames) * gw * gh, slots=len(frames) * cfg["n_gaussians"])
    return total
