"""Shared pieces of the benchmark's CPU tests: the program and the
benchmark on the path, and a cell cut to a size the CPU runs in seconds
(the card's cells keep their sizes; only these tests shrink them)."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_route_cell():
    """paper-route-open at D = 64 over 1,400 prompts, 2 s of traffic of
    8-32 queries a batch."""
    from eaglebench import spec
    cell = dict(spec.cell("paper-route-open"), name="paper-route-open",
                rate_hz=15.0)
    cfg = copy.deepcopy(spec.config(cell["config"]))
    cfg["router"]["embed_dim"] = 64
    cfg["corpus"]["prompts_per_dataset"] = 200
    cfg["db"]["capacity"] = 2048
    mix = copy.deepcopy(spec.mix(cell["traffic"]))
    mix["route"].update(batch_min=8, batch_max=32)
    mix["feedback"].update(rate_hz=2.0, prompts=10)
    mix["check"]["sample_batches"] = 8
    return cell, cfg, mix


@pytest.fixture
def run_tiny(tmp_path):
    """Run the tiny route cell on the CPU (the harness's look for a card
    skipped) and return its record."""
    import time

    import torch

    from eaglebench.drivers import route_open

    def go(seed=5, control=False, traced=False):
        torch.set_num_threads(1)
        cell, cfg, mix = tiny_route_cell()
        return route_open.run(cell, cfg, mix, seed=seed, seconds=2.0,
                              traced=traced, device=torch.device("cpu"),
                              t_start=time.perf_counter(), out_dir=tmp_path,
                              control=control)
    return go

