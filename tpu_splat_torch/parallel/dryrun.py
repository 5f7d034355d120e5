"""A multi-process dry run of the batched step (counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip` and `tools/dryrun_multihost.py`).

    python -m tpu_splat_torch.parallel.dryrun [--device cpu] -n 2 [--data 1] [--steps 2]

spawns N processes joined by a gloo process group on loopback, builds the same random
scene in each (numpy, from `Scene.seed`), shards it over a (data, gauss) mesh, takes
`--steps` batched MCMC steps over `Scene.batch` distinct cameras, gathers the state,
refines it (MCMC relocate and grow, on every rank alike) and re-shards it, takes one more
step, and prints each step's loss and the alive count. `run(...)` does the same from Python and returns the
gathered state of rank 0 (world 1 runs in this process, with no process group), so that a
caller can hold a world of N against the world of 1.

It runs on the card unless asked for `--device cpu`: every rank on card 0 (gloo through
host memory; NCCL needs a card a rank and is not what this script runs), raising without
a card. `--device cpu` is the CPU rehearsal of the same program.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import socket
import sys
import time
from typing import Any

import numpy as np
import torch

from ..core.splat import SplatState
from ..device import resolve_device
from ..training.train_step import RasterPlan, StepConfig, init_train_state, refine_step
from .distributed import initialize, shutdown
from .mesh import gather_train_state, make_mesh, shard_train_state
from .step import make_batched_train_step


@dataclasses.dataclass(frozen=True)
class Scene:
    """A random scene and its cameras, made the same in every process from `seed`."""

    n_gauss: int = 100
    capacity: int = 512
    width: int = 32
    height: int = 32
    batch: int = 2
    seed: int = 11
    tile_size: int = 16
    chunk: int = 128
    sh_degree: int = 1
    scale: float = 0.05  # the Gaussians' mean scale (world units; they sit at z ~ 5)


def random_splat(scene: Scene, device) -> SplatState:
    """`n_gauss` alive Gaussians at random capacity rows (so that every gauss shard holds
    some), in front of the cameras, from numpy draws."""
    rng = np.random.default_rng(scene.seed)
    n, cap = scene.n_gauss, scene.capacity
    k = (scene.sh_degree + 1) ** 2 - 1
    rows = np.sort(rng.permutation(cap)[:n])
    means = np.zeros((cap, 3), np.float32)
    means[rows] = rng.normal(0, 0.8, (n, 3)) * [1.0, scene.height / scene.width, 0.4]
    means[rows, 2] += 5.0
    scales = np.full((cap, 3), -8.0, np.float32)
    scales[rows] = np.log(scene.scale * (0.4 + 1.6 * rng.random((n, 3))))
    quats = np.zeros((cap, 4), np.float32)
    quats[:, 0] = 1.0
    quats[rows] = rng.normal(0, 0.5, (n, 4)) + [2.0, 0, 0, 0]
    opacity = np.full((cap, 1), -6.0, np.float32)
    opacity[rows] = rng.normal(0.0, 1.0, (n, 1))
    sh0 = np.zeros((cap, 1, 3), np.float32)
    sh0[rows] = rng.normal(0, 1, (n, 1, 3))
    shn = np.zeros((cap, k, 3), np.float32)
    shn[rows] = rng.normal(0, 0.1, (n, k, 3))
    alive = np.zeros(cap, bool)
    alive[rows] = True
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return SplatState(means=t(means), sh0=t(sh0), shN=t(shn), scaling_raw=t(scales),
                      rotation_raw=t(quats), opacity_raw=t(opacity), alive=t(alive),
                      max_sh_degree=scene.sh_degree, scene_scale=1.0)


def cameras(scene: Scene):
    """B distinct cameras (small yaw and offset around the identity) and their targets:
    (gts [B, 3, H, W], w2cs [B, 4, 4], cam_positions [B, 3], intr [B, 4]) as numpy."""
    rng = np.random.default_rng(scene.seed + 1)
    b, w, h = scene.batch, scene.width, scene.height
    w2cs, cpos = [], []
    for i in range(b):
        th = 0.08 * (i - (b - 1) / 2)
        r = np.array([[math.cos(th), 0, math.sin(th)], [0, 1, 0],
                      [-math.sin(th), 0, math.cos(th)]], np.float32)
        p = np.array([0.3 * th, 0.05 * i, 0.0], np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3], m[:3, 3] = r, -r @ p
        w2cs.append(m)
        cpos.append(p)
    f = 0.9 * w
    intr = np.tile(np.array([f, f, w / 2.0, h / 2.0], np.float32), (b, 1))
    gts = rng.random((b, 3, h, w)).astype(np.float32)
    return gts, np.stack(w2cs), np.stack(cpos), intr


def plan_for(scene: Scene, gauss: int) -> RasterPlan:
    """The Trainer's plan: instance budget from the alive count, the gather budget
    min(next bucket of 2 n / G, shard capacity) (trainer.py:249-253)."""
    from ..training.trainer import _next_bucket

    shard_cap = scene.capacity // gauss
    return RasterPlan(max_instances=max(_next_bucket(scene.n_gauss * 8), 1 << 13),
                      k_max=256 if scene.n_gauss < 10_000 else 4096, chunk=scene.chunk,
                      tile_size=scene.tile_size,
                      gather_budget=min(_next_bucket(max(scene.n_gauss // gauss, 1) * 2),
                                        shard_cap))


def run_rank(rank: int, world: int, data: int, scene: Scene, device: str, steps: int,
             address: str | None = None) -> dict[str, Any]:
    """One rank's dry run (a world of 1 without a process group). -> on every rank: the
    losses, each step's wall seconds (it ends reading the loss), the refine's counts, and
    the gathered state's splat (before the refine and at the end) and Adam moments as
    numpy."""
    rt = initialize(address, world, rank, backend=None if world == 1 else "gloo",
                    device=device)
    try:
        mesh = make_mesh(world, data=data, rank=rt.rank)
        ts = init_train_state(random_splat(scene, rt.device), seed=5, device=rt.device)
        ts = shard_train_state(mesh, ts)
        gts, w2cs, cpos, intr = cameras(scene)
        step = make_batched_train_step(mesh)
        kw = dict(width=scene.width, height=scene.height, plan=plan_for(scene, mesh.gauss),
                  opt=StepConfig(), total_iterations=100)
        bg = np.zeros(3, np.float32)
        losses, counts, step_s = [], [], []
        for i in range(steps + 1):
            if i == steps:  # refine on the whole state, alike on every rank, then re-shard
                full = gather_train_state(mesh, ts)
                before = {k: v.cpu().numpy() for k, v in full.splat.params().items()}
                full, info = refine_step(full, min_opacity=0.005, max_cap=scene.n_gauss * 2)
                ts = shard_train_state(mesh, full)
                refine = {k: int(v) for k, v in info.items()}
            t0 = time.perf_counter()
            ts, st = step(ts, gts, w2cs, cpos, intr, bg, **kw)
            losses.append(float(st.loss))
            step_s.append(time.perf_counter() - t0)
            counts.append([int(x) for x in st[1:]])
        full = gather_train_state(mesh, ts)
        return dict(losses=losses, counts=counts, step_s=step_s, refine=refine,
                    mesh=(mesh.data, mesh.gauss),
                    params_before_refine=before,
                    params={k: v.cpu().numpy() for k, v in full.splat.params().items()},
                    alive=full.splat.alive.cpu().numpy(),
                    exp_avg={k: v.cpu().numpy() for k, v in full.adam.exp_avg.items()})
    finally:
        shutdown()


def _worker(rank, world, data, scene, device, steps, address, queue):
    if device == "cpu":
        # one thread a rank: the ranks share the host's cores, and PyTorch's threaded CPU
        # kernels were seen to round an exp differently from run to run
        torch.set_num_threads(1)
    out = run_rank(rank, world, data, scene, device, steps, address)
    if rank == 0:
        queue.put(out)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(world: int, data: int = 1, scene: Scene = Scene(), device: str = "cuda",
        steps: int = 1, timeout: float = 600.0) -> dict[str, Any]:
    """The dry run over `world` processes (spawned; a world of 1 runs here) on `device`:
    "cuda" is card 0 for every rank (raising without a card), "cpu" the CPU. -> rank 0's
    result of `run_rank`. Raises if a process fails or outlives `timeout`."""
    device = str(resolve_device("cuda:0" if str(device) == "cuda" else device))
    if world == 1:
        return run_rank(0, 1, 1, scene, device, steps)
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    address = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_worker,
                         args=(r, world, data, scene, device, steps, address, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=timeout)  # drained before the joins
    except Exception as e:
        raise RuntimeError(f"the dry run over {world} processes gave no result: "
                           f"exit codes {[p.exitcode for p in procs]}") from e
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a dry-run process failed: exit codes {bad}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_splat_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--processes", type=int, default=2)
    ap.add_argument("--data", type=int, default=1, help="the mesh's data axis")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: every rank on card 0), or cpu")
    ap.add_argument("--steps", type=int, default=1, help="batched steps before the refine")
    args = ap.parse_args(argv)
    out = run(args.processes, args.data, Scene(), args.device, args.steps)
    print(f"mesh {out['mesh']}: losses {out['losses']}, refine {out['refine']}, "
          f"n_alive {int(out['alive'].sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
