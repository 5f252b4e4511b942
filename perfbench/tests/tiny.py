"""Tiny versions of the cells, for the CPU: the same files with the sizes cut
so that a run of the plain route takes seconds."""
from __future__ import annotations

import torch

from perfbench import harness


def tiny_cell(cell_name: str):
    """(cell, config, mix) of `cell_name` at a size the CPU runs in seconds:
    32 x 24 frames, a few cameras, 256 slots, chunks of 2 steps."""
    cell = harness.load("workloads", cell_name)
    config = harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    sc = config["scene"]
    sc.update(width=32, height=24, fx=24.0, fy=24.0, cx=16.0, cy=12.0, capacity=256, alive=192)
    if sc["eval_every"] == 9:
        sc.update(n_train=16, n_eval=2)
    else:
        sc.update(n_train=14, n_eval=2)
    config["extra_flags"] = config["extra_flags"] + ["--trainer.sync-every", "2"]
    if mix["kind"] == "train":
        mix.update(warmup_steps=0)
    else:
        mix.update(path_frames=8, trace_frames=3, warmup_frames=1)
    return cell, config, mix


def run_tiny(cell_name: str, seed: int = 20261017, trace: bool = False, seconds: float = 0.5,
             bench=None):
    from perfbench import run

    torch.set_num_threads(2)
    cell, config, mix = tiny_cell(cell_name)
    return run.run_cell(cell_name, seed, seconds, trace, device="cpu", cell=cell, config=config,
                        mix=mix, bench=bench)
