"""splatbench's tests: the harness's modules and the program importable, and a cell cut
to a size the CPU runs in seconds through the kernels' plain versions.

    python -m pytest -p no:cacheprovider splatbench/tests
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(name: str) -> dict:
    """The cell `name` of BENCHMARK.json at 3000 Gaussians, 96x64, 4 views."""
    import run as sbrun

    bench = sbrun.read_json(ROOT / "BENCHMARK.json")
    cell = sbrun.load_cell(bench, name)
    cell["config"].update(n_gaussians=3000, width=96, height=64, views=4)
    cell["config"]["optimization"] = dict(cell["config"]["optimization"], max_cap=3000)
    cell["traffic"].update(sfm_points=200, warmup_min_iters=8, warmup_stable_iters=8,
                           trace_iters=4, poses=8, compare_frames=2, warmup_frames=1,
                           trace_frames=2)
    return cell


@pytest.fixture
def cpu():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield torch.device("cpu")
    torch.set_num_threads(threads)
