"""Batched, multi-device training over a ("data", "gauss") mesh of torch.distributed ranks
(port of `tpu_splat/parallel/`): one process per rank; `mesh.py` (the mesh, its process
groups and collectives, the state's sharding), `distributed.py` (process-group setup),
`raster_mc.py` (the windowed render of a camera batch), `step.py` (the batched train step),
`dryrun.py` (N gloo processes, one step and one refine)."""
