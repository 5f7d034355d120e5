"""The ("data", "gauss") mesh of torch.distributed ranks and the train state's layout (port
of `tpu_splat/parallel/mesh.py`).

One process per rank; rank = d * gauss + g:
  * "gauss": the Gaussian capacity is split over the G ranks that share a data coordinate d
    (the gauss group) — rank (d, g) holds capacity rows [g C/G, (g+1) C/G) of every splat
    leaf, `alive`, Adam's moments and the ADC densification info; projection, SH, Adam and
    the MCMC noise run on those rows alone. Each of the G ranks renders a window of the
    image's tile rows from the all-gathered projected features (`raster_mc.py`).
  * "data": the camera batch is split over the D ranks that share g (the data group); the
    parameter gradients are summed over it.
Step counts, the generator, the iteration and the component states (bilateral grids, pose
parameters, their optimizers, ADMM) are replicated, as `state_shardings` replicates them
in the JAX package (:37-63).

In a world of 1 there is no process group: the groups are None and every collective is
the identity, so the 1x1 mesh runs the batched path on one device with no
torch.distributed at all. On the gloo backend a CUDA tensor goes through host memory for
each collective (chosen by the backend's name; gloo's CUDA support covers few of them).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..training.optim import AdamState
from ..training.train_step import TrainState

AXES = ("data", "gauss")


def mesh_shape(world: int, data: int | None = None) -> tuple[int, int]:
    """(data, gauss) of a mesh over `world` ranks; `data` defaults to 1 (every rank on the
    Gaussian axis), the JAX package's rule (mesh.py:26-34)."""
    d = data or 1
    if world < 1 or world % d:
        raise ValueError(f"{world} ranks not divisible by data={d}")
    return d, world // d


def trainer_mesh_shape(world: int, batch: int, mesh_data: int = 0,
                       mesh_gauss: int = 0) -> tuple[int, int]:
    """The Trainer's mesh over `world` ranks for `batch` cameras a step and the CLI's
    `--mesh-data` / `--mesh-gauss` (0 = unset): the JAX Trainer's rule
    (trainer.py:214-225). The data axis is `mesh_data`, else the largest divisor of the
    world not above the batch; `mesh_gauss` sets the gauss axis when data x gauss fits.
    Raises when the batch does not split over the data axis, or when the mesh would leave
    ranks without a coordinate (the JAX Trainer leaves such devices idle; a launched
    process cannot be)."""
    data = mesh_data or min(batch, world)
    while world % data:
        data -= 1
    n = world
    if mesh_gauss and data * mesh_gauss <= world:
        n = data * mesh_gauss
    if batch % data:
        raise ValueError(f"batch_size {batch} not divisible by mesh data={data}")
    if n != world:
        raise ValueError(f"a mesh of {data} x {n // data} uses {n} of the {world} ranks: "
                         f"launch {n} processes")
    return data, n // data


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, gauss) mesh and its two process groups."""

    data: int
    gauss: int
    rank: int = 0
    backend: Optional[str] = None  # None: a world of 1, no process group
    gauss_group: Any = None  # the ranks with this rank's d (None in a world of 1)
    data_group: Any = None  # the ranks with this rank's g (None in a world of 1)
    host_group: Any = None  # every rank over gloo, for host flags (None in a world of 1)

    @property
    def world(self) -> int:
        return self.data * self.gauss

    @property
    def d(self) -> int:
        return self.rank // self.gauss

    @property
    def g(self) -> int:
        return self.rank % self.gauss

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "gauss": self.gauss}

    def shard_rows(self, capacity: int) -> slice:
        """This rank's rows of a capacity axis of `capacity` (the global capacity)."""
        if capacity % self.gauss:
            raise ValueError(f"capacity {capacity} not divisible by mesh gauss={self.gauss}")
        c = capacity // self.gauss
        return slice(self.g * c, (self.g + 1) * c)

    # ---------------------------------------------------------------- collectives

    def _group(self, axis: str):
        if axis not in AXES + ("world",):
            raise ValueError(f"axis must be one of {AXES + ('world',)}, got {axis!r}")
        return {"gauss": self.gauss_group, "data": self.data_group,
                "world": dist.group.WORLD}[axis]

    def axis_size(self, axis: str) -> int:
        return {"gauss": self.gauss, "data": self.data, "world": self.world}[axis]

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor a collective of this backend takes: gloo gets host memory."""
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return x.cpu() if self.backend == "gloo" else x

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' `x` of one axis stacked along dim 0, in coordinate order."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        xs = self._staged(x)
        out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
        dist.all_gather_into_tensor(out, xs, group=self._group(axis))
        return out.to(device=x.device, dtype=x.dtype)

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of the ranks' `x` of one axis, cut along dim 0: this rank's part."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        xs = self._staged(x)
        out = xs.new_empty((xs.shape[0] // n, *xs.shape[1:]))
        dist.reduce_scatter_tensor(out, xs, op=dist.ReduceOp.SUM, group=self._group(axis))
        return out.to(device=x.device, dtype=x.dtype)

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Sum (or max) of the ranks' `x` of one axis; a new tensor, `x` untouched."""
        if self.axis_size(axis) == 1:
            return x
        xs = self._staged(x).clone()
        dist.all_reduce(xs, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=self._group(axis))
        return xs.to(device=x.device, dtype=x.dtype)

    def any_rank(self, flags: list[bool]) -> list[bool]:
        """Each of `flags` set on any rank of the world: a max over host memory through a
        gloo group, so that no rank waits for its card's queue to drain."""
        if self.world == 1:
            return [bool(f) for f in flags]
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return [bool(v) for v in t.tolist()]

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def make_mesh(world: int = 1, data: int | None = None, rank: int | None = None) -> Mesh:
    """A (data, gauss) mesh over `world` ranks (`mesh_shape`'s rule). With world > 1 the
    default process group must be up (`distributed.initialize`) and every rank must call
    this in the same order: it creates the D gauss groups and the G data groups."""
    d, g = mesh_shape(world, data)
    if world == 1:
        return Mesh(data=1, gauss=1)
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(f"a mesh of {world} ranks needs a process group of {world} ranks "
                           "(parallel/distributed.py::initialize)")
    rank = dist.get_rank() if rank is None else rank
    gauss_group = data_group = None
    for di in range(d):
        grp = dist.new_group([di * g + gi for gi in range(g)])
        if di == rank // g:
            gauss_group = grp
    for gi in range(g):
        grp = dist.new_group([di * g + gi for di in range(d)])
        if gi == rank % g:
            data_group = grp
    backend = dist.get_backend()
    host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(data=d, gauss=g, rank=rank, backend=backend, gauss_group=gauss_group,
                data_group=data_group, host_group=host_group)


def _capacity_leaves(ts: TrainState) -> dict[str, torch.Tensor]:
    """The sharded leaves of a TrainState (capacity rows first), by path."""
    out = {f"splat.{k}": v for k, v in ts.splat.params().items()}
    out["splat.alive"] = ts.splat.alive
    out.update({f"exp_avg.{k}": v for k, v in ts.adam.exp_avg.items()})
    out.update({f"exp_avg_sq.{k}": v for k, v in ts.adam.exp_avg_sq.items()})
    out["dens_count"] = ts.dens_count
    out["dens_grad2d"] = ts.dens_grad2d
    return out


def _rebuild(ts: TrainState, leaves: dict[str, torch.Tensor]) -> TrainState:
    params = {k.split(".", 1)[1]: v for k, v in leaves.items() if k.startswith("splat.")}
    alive = params.pop("alive")
    splat = dataclasses.replace(ts.splat, alive=alive, **params)
    adam = AdamState(
        exp_avg={k: leaves[f"exp_avg.{k}"] for k in ts.adam.exp_avg},
        exp_avg_sq={k: leaves[f"exp_avg_sq.{k}"] for k in ts.adam.exp_avg_sq},
        step_count=dict(ts.adam.step_count),
    )
    return dataclasses.replace(ts, splat=splat, adam=adam, dens_count=leaves["dens_count"],
                               dens_grad2d=leaves["dens_grad2d"])


def shard_train_state(mesh: Mesh, ts: TrainState) -> TrainState:
    """This rank's part of a whole TrainState (the same state on every rank): capacity
    rows `mesh.shard_rows(C)` of the splat, `alive`, Adam's moments and the densification
    info; the rest shared with the whole state (`state_shardings`, mesh.py:37-63)."""
    if mesh.gauss == 1:
        return ts
    rows = mesh.shard_rows(ts.splat.capacity)
    return _rebuild(ts, {k: v[rows].clone() for k, v in _capacity_leaves(ts).items()})


def gather_train_state(mesh: Mesh, ts: TrainState) -> TrainState:
    """The whole TrainState from each gauss rank's part (`shard_train_state`'s inverse): a
    collective of the gauss group; every rank of it gets the same state."""
    if mesh.gauss == 1:
        return ts
    return _rebuild(ts, {k: mesh.all_gather(v, "gauss")
                         for k, v in _capacity_leaves(ts).items()})
