"""What the traffic modules share: the cell's files, the configurations
handed to the program and to the reference, the tile-capacity rule, the
camera order, and the comparisons that decide `correct`.

Nothing here imports the program at module level: `program_configs` imports
its configuration parser when called.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """perfbench/<kind>/<name>.json."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


# ------------------------------------------------------------ configurations
def program_configs(config: dict, seed: int, device):
    """(SplatfactoConfig, TrainerConfig) of the program from the variant's
    command line, as `splat_tpu_torch.cli.fit` builds them: its own parser
    over the configuration's `flags` and `extra_flags`."""
    from splat_tpu_torch.engine.config import parse_cli

    run = parse_cli(["splatfacto", *config["flags"], *config.get("extra_flags", [])])
    tc = dataclasses.replace(run.trainer, max_steps=run.max_num_iterations, seed=seed)
    return run.model, tc


def _coerce(value: str, current):
    if isinstance(current, bool):
        return value in ("True", "true", "1")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def reference_configs(config: dict, seed: int):
    """(reference SplatfactoConfig, trainer settings dict) from the same
    flags, by the benchmark's own reading of them: `--pipeline.model.a-b.c-d V`
    sets field a_b.c_d of the frozen config; `--max-num-iterations` sets
    max_steps, `--trainer.name V` the trainer setting `name` where the
    reference has it. The trainer's other settings are the configuration's
    `trainer` block (the program's defaults at commit 49129b2)."""
    from .reference import model as rm

    cfg = rm.SplatfactoConfig()
    tc = dict(config["trainer"], seed=seed)
    flags = [*config["flags"], *config.get("extra_flags", [])]
    for key, value in zip(flags[::2], flags[1::2]):
        if key == "--max-num-iterations":
            tc["max_steps"] = int(value)
            continue
        if key.startswith("--trainer."):
            # the trainer's settings that change the arithmetic are in `tc`;
            # the others (how often the host waits) the reference has not
            name = key[len("--trainer."):].replace("-", "_")
            if name in tc:
                tc[name] = _coerce(value, tc[name])
            continue
        if not key.startswith("--pipeline.model."):
            raise ValueError(f"the reference does not read the flag {key}")
        path = key[len("--pipeline.model."):].replace("-", "_").split(".")
        if len(path) == 1:
            cfg = dataclasses.replace(cfg, **{path[0]: _coerce(value, getattr(cfg, path[0]))})
        else:
            sub = getattr(cfg, path[0])
            sub = dataclasses.replace(sub, **{path[1]: _coerce(value, getattr(sub, path[1]))})
            cfg = dataclasses.replace(cfg, **{path[0]: sub})
    return cfg, tc


def tile_capacity(counts_per_camera, k0: int, tol: float, k_max: int) -> int:
    """The per-tile capacity that the trainer's adaptation rule
    (`engine/trainer.py:_maybe_adapt_tile_capacity` at 49129b2) reaches once
    it has probed every camera: where a camera drops more than `tol` of its
    entries at the current K, K doubles until it holds that camera's fullest
    tile, up to k_max. counts_per_camera: the unclamped per-tile populations,
    one array per camera."""
    k = k0
    for _ in range(16):
        grew = False
        for counts in counts_per_camera:
            counts = np.asarray(counts, np.int64)
            total = max(int(counts.sum()), 1)
            if k < k_max and int(np.maximum(counts - k, 0).sum()) > tol * total:
                while k < int(counts.max()) and k < k_max:
                    k *= 2
                k = min(k, k_max)
                grew = True
        if not grew:
            break
    return k


def probe_cameras(n_train: int, seed: int, count: int) -> list[int]:
    """The train cameras whose binning the tile-capacity rule probes: `count`
    of them drawn from the seed (the trainer probes one camera at each
    refine, so a run that has reached the resumed step has probed dozens)."""
    if count >= n_train:
        return list(range(n_train))
    rng = np.random.default_rng(int(seed) % (2**63) + 3)
    return sorted(rng.choice(n_train, size=count, replace=False).tolist())


def camera_order(n_train: int, seed: int, start: int, steps: int) -> list[int]:
    """The train camera of each of `steps` steps from `start` for a trainer
    that starts there with no epoch order yet: a permutation drawn from a CPU
    generator seeded with the seed whenever the step count is a multiple of
    n_train (and at the first step)."""
    gen = torch.Generator().manual_seed(int(seed) % (2**63))
    out, order = [], None
    for s in range(start, start + steps):
        i = s % n_train
        if i == 0 or order is None:
            order = torch.randperm(n_train, generator=gen).tolist()
        out.append(int(order[i]))
    return out


# ---------------------------------------------------------------- comparison
def worst_leaf_gap(program: dict[str, float], reference: dict[str, float],
                   leaves=None) -> tuple[float, str]:
    """max over leaves of |program norm - reference norm| / max(reference
    norm of the leaf, the median leaf's reference norm), and that leaf."""
    names = [k for k in reference if leaves is None or k in leaves]
    med = statistics.median(reference[k] for k in names)
    worst, which = 0.0, ""
    for k in names:
        p = program.get(k, 0.0)
        gap = abs(p - reference[k]) / max(reference[k], med, 1e-30)
        if not np.isfinite(gap):
            gap = float("inf")
        if gap >= worst:
            worst, which = gap, k
    return worst, which


def device_info(chips: int) -> dict:
    """The `device` block of the result line."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}
