#!/usr/bin/env python3
"""Train the JAX package's Trainer and the port's side by side on the CPU, step by step.

    python3 scripts_dev/long_parity_witness.py lockstep [--case rs|rs_baseline|mb]
        [--steps N] [--resolution PX] [--out DIR]
    python3 scripts_dev/long_parity_witness.py seeds [--case rs] [--seeds 42,0,1]
        [--packages jax,torch] [--steps N] [--resolution PX] [--out DIR]
    python3 scripts_dev/long_parity_witness.py self [--case rs] [--steps N] ...
    python3 scripts_dev/long_parity_witness.py report [--out DIR]

Runs on the CPU with JAX on its `jnp` tile route and the port on its kernels'
plain versions (`device="cpu"`). The scene is the synthetic suite's, written
by each package's own `generate_synthetic_suite` (the two are compared
pixel by pixel); both trainers then train on the JAX copy's arrays, so that
they differ only in their own code.

`lockstep` trains one case with both trainers in lockstep, from one seed,
with `cli/train.py`'s synthetic flags for the variant and the `--draft`
schedule (3000 steps, refine every 100 after 500, SH degree raised every
1000). The camera order is one numpy sequence fed to both
`_next_camera_index`es, and every refine's split offsets are the JAX
refine's own `jax.random` draws handed to the port's `_split_noise`, as
`tests/test_torch_trainer.py` does for 45 steps. Recorded: each step's loss
on both and their relative difference; both eval PSNRs every 250 steps;
`n_alive` and the refine counts at every refine; the largest difference of
each leaf over the slots alive in both, as a share of the leaf's largest
value, at every refine and opacity reset.

Cases (dataset, scene, variant):
- `rs`: synthetic-rs scene1, rolling_shutter;
- `rs_baseline`: synthetic-rs scene1, baseline;
- `mb`: synthetic-mb scene0, motion_blur (10 blur samples in 4 anchors).

`self` is the rounding control: the port against a copy of itself whose
leaves start one float32 ulp away, with the same draws; how fast that pair
parts is how fast rounding alone parts two runs of this schedule.

`seeds` trains each package alone (no shared draws) on `rs_baseline` and
`rs` at each seed and reports the rolling-shutter margin (its eval PSNR
minus the baseline's) per package and seed. `report` summarises the result
files under OUT.

Reductions the CPU forces (the suite's shapes otherwise: 1500 Gaussians,
33 frames of which 5 are eval frames, 17 ground-truth blur samples, the
suite's exposure / readout and shake):
- resolution 512 -> `--resolution` (default 128; 64 for rs and 48 for mb
  in the recorded runs), which scales the intrinsics with it;
- `--steps` (default 3000 for rs, 1500 for mb);
- `--reset-every R` (refines between opacity resets; the schedule's 30
  puts the first reset at step 3000, which a 3000-step run skips for lack
  of a recovery window) brings the resets inside the steps run.

Writes OUT/<mode>_<case>_r<px>[_s<seeds>].json (default OUT chiprun_out/long_parity) and
prints a summary line. On an 8-core x86 server, lockstep takes about 0.5 s a
step pair at 64 px (rs, one case alone; 1 s with two more beside it) and
2-3 s at 48 px (mb: ten blur samples in four anchors).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "cli"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

CASES = {
    "rs": ("synthetic-rs", "scene1", "rolling_shutter"),
    "rs_baseline": ("synthetic-rs", "scene1", "baseline"),
    "mb": ("synthetic-mb", "scene0", "motion_blur"),
}
EVAL_EVERY = 250
EARLY = 45           # the steps tests/test_torch_trainer.py holds to 1e-3


def make_suites(work: Path, resolution: int, dataset: str) -> dict:
    """Both packages' suites for one dataset; returns their largest pixel and
    transforms.json differences."""
    import generate_synthetic_suite as jsuite

    from splat_tpu_torch.cli import generate_synthetic_suite as tsuite

    variant = dataset.split("-")[1]
    common = ["--resolution", str(resolution), "--scenes", "2", "--variants", variant]
    jdir, tdir = work / "jax", work / "torch"
    if not (jdir / dataset / "scene1" / "transforms.json").exists():
        jsuite.main(["--input-dir", str(jdir), *common])
    if not (tdir / dataset / "scene1" / "transforms.json").exists():
        tsuite.main(["--input-dir", str(tdir), *common, "--device", "cpu"])
    from splat_tpu_torch.data.png import read_png
    out = {}
    for scene in ("scene0", "scene1"):
        a, b = jdir / dataset / scene, tdir / dataset / scene
        same_json = (a / "transforms.json").read_bytes() == (b / "transforms.json").read_bytes()
        diff = max(int(np.abs(read_png(p).astype(np.int32)
                              - read_png(b / "images" / p.name).astype(np.int32)).max())
                   for p in sorted((a / "images").glob("*.png")))
        out[scene] = {"transforms_json_equal": same_json, "max_pixel_diff_8bit": diff}
    return out


def argv_for(scene_dir: Path, dataset: str, variant: str, steps: int, seed: int) -> list[str]:
    from splat_tpu_torch.cli import train as cli_train

    _, flags = cli_train.flags_to_variant_name_and_cmd(
        set() if variant == "baseline" else set(variant.split("-")), dataset, False)
    dp = cli_train.dataset_params(dataset)
    return ["splatfacto", "--data", str(scene_dir), "--max-num-iterations", str(steps),
            "--seed", str(seed), *flags, "nerfstudio-data", "--eval-mode", dp["eval_mode"],
            "--eval-interval", str(dp["eval_interval"]),
            "--orientation-method", dp["orientation_method"]]


def build_pair(scene_dir: Path, dataset: str, variant: str, steps: int, seed: int,
               reset_every: int | None, jax_only=False, torch_only=False):
    """The JAX and the port trainers as `cli.fit` builds them from one argv."""
    from splat_tpu.data import dataparser as jdp
    from splat_tpu.data import dataset as jds
    from splat_tpu.engine import config as jcfg
    from splat_tpu.engine import trainer as jtr
    from splat_tpu_torch.engine import config as tcfg
    from splat_tpu_torch.engine import trainer as ttr
    from splat_tpu_torch.models.convert import scene_from_numpy

    argv = argv_for(scene_dir, dataset, variant, steps, seed)
    jc, tc = jcfg.parse_cli(argv), tcfg.parse_cli(argv)
    if reset_every:
        jc = dataclasses.replace(jc, model=dataclasses.replace(jc.model,
                                                               reset_alpha_every=reset_every))
        tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model,
                                                               reset_alpha_every=reset_every))
    jscene = jdp.parse_scene(jc.data, jc.dataparser)
    jtrc = dataclasses.replace(jc.trainer, max_steps=steps, seed=seed, log_every=1)
    ttrc = dataclasses.replace(tc.trainer, max_steps=steps, seed=seed, log_every=1)
    jt = tt = None
    if not torch_only:
        jt = jtr.Trainer(jscene, jc.model, jtrc)
    if not jax_only:
        train_imgs, eval_imgs = jds.load_scene_images(jscene)

        def cam_fields(cams):
            d = {k: np.asarray(getattr(cams, k)) for k in cams._leaf_names}
            return dict(d, width=cams.width, height=cams.height)

        tree = dict(train_cameras=cam_fields(jscene.train_cameras),
                    eval_cameras=cam_fields(jscene.eval_cameras),
                    train_images=train_imgs.images, eval_images=eval_imgs.images,
                    train_paths=jscene.train_paths, eval_paths=jscene.eval_paths,
                    points_xyz=jscene.points_xyz, points_rgb=jscene.points_rgb)
        scene, t_train, t_eval = scene_from_numpy(tree, device="cpu")
        tt = ttr.Trainer(scene, tc.model, ttrc, train_images=t_train, eval_images=t_eval,
                         device="cpu")
    return jt, tt


def _jax_leaf(params, name):
    head, _, tail = name.partition(".")
    node = getattr(params, head)
    for part in tail.split(".") if tail else []:
        node = node[part] if isinstance(node, dict) else getattr(node, part)
    return np.asarray(node)


def leaf_diffs(jt, tt) -> dict:
    """Largest |port - JAX| of every leaf over the slots alive in both, as a
    share of the JAX leaf's largest |value| there; and the alive mismatch."""
    from splat_tpu_torch.models.convert import named_leaves

    ja = np.asarray(jt.params.gaussians.alive) > 0.5
    ta = tt.params.gaussians.alive.numpy() > 0.5
    out = {"alive_mismatch": int((ja != ta).sum()) if ja.shape == ta.shape else -1}
    both = ja & ta if ja.shape == ta.shape else None
    for name, leaf in named_leaves(tt.params).items():
        if name.endswith("alive"):
            continue
        t, j = leaf.detach().numpy(), _jax_leaf(jt.params, name)
        if t.shape != j.shape:
            out[name] = None
            continue
        if name.startswith("gaussians.") and both is not None:
            t, j = t[both], j[both]
        scale = float(np.abs(j).max()) if j.size else 0.0
        out[name] = float(np.abs(t - j).max() / scale) if scale > 0 else float(np.abs(t - j).max())
    return out


def lockstep(args, work: Path) -> dict:
    dataset, session, variant = CASES[args.case]
    suites = make_suites(work / "suite", args.resolution, dataset)
    scene_dir = work / "suite" / "jax" / dataset / session
    jt, tt = build_pair(scene_dir, dataset, variant, args.steps, args.seed, args.reset_every)
    assert jt.model_config.blur_anchors == tt.model_config.blur_anchors
    n_train = len(tt.train_cams)
    rng = np.random.default_rng(args.seed)
    order = np.concatenate([rng.permutation(n_train)
                            for _ in range(args.steps // n_train + 2)])
    jt._next_camera_index = lambda n: int(order[jt.step])
    tt._next_camera_index = lambda n: int(order[tt.step])

    pending, jinfo = [], []

    def spy_on(refine):
        def spy(gaussians, state, step):
            # make_refine splits state.key and draws both offsets from k_split
            _, k_split = jax.random.split(state.key)
            shape = gaussians.means.shape
            pending.append((np.asarray(jax.random.normal(k_split, shape)),
                            np.asarray(jax.random.normal(jax.random.fold_in(k_split, 1),
                                                         shape))))
            out = refine(gaussians, state, step)
            jinfo.append({k: int(v) for k, v in out[3].items()})
            return out
        spy.is_spy = True
        return spy

    def split_noise(shape):
        eps, eps2 = pending.pop(0)
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return torch.tensor(eps), torch.tensor(eps2)

    tt._split_noise = split_noise

    rec = {"case": args.case, "dataset": dataset, "session": session, "variant": variant,
           "resolution": args.resolution, "steps": args.steps, "seed": args.seed,
           "reset_alpha_every": jt.model_config.reset_alpha_every,
           "blur_samples": tt.model_config.blur_samples,
           "blur_anchors": tt.model_config.blur_anchors, "suites": suites,
           "loss_jax": [], "loss_torch": [], "loss_rel_diff": [], "eval": [], "refines": [],
           "leaves": []}
    j0, t0 = jt.evaluate(), tt.evaluate()
    rec["eval"].append({"step": 0, "psnr_jax": j0["psnr"], "psnr_torch": t0["psnr"]})
    n_events = 0
    clock = time.time()
    for step in range(1, args.steps + 1):
        if not getattr(jt.refine, "is_spy", False):
            jt.refine = spy_on(jt.refine)       # the JAX trainer rebuilds it when it grows
        jl = jt.run(1)[-1]["loss"]
        tl = tt.run(1)[-1]["loss"]
        rec["loss_jax"].append(jl)
        rec["loss_torch"].append(tl)
        rec["loss_rel_diff"].append(abs(tl - jl) / abs(jl))
        if len(tt.refine_events) > n_events:
            n_events = len(tt.refine_events)
            ev = dict(tt.refine_events[-1])
            ji = jinfo[-1] if len(jinfo) == n_events else None
            rec["refines"].append({
                "step": step, "torch": ev, "jax": ji,
                "counts_equal": ji is not None and all(ev.get(k) == v for k, v in ji.items()),
                "n_alive_jax": int(np.asarray(jt.params.gaussians.alive).sum()),
                "n_alive_torch": int(tt.params.gaussians.alive.sum()),
                "reset": bool(ev.get("reset")),
                "last_reset_step": [jt._last_reset_step, tt._last_reset_step]})
            rec["leaves"].append({"step": step, "reset": bool(ev.get("reset")),
                                  **leaf_diffs(jt, tt)})
        if step % EVAL_EVERY == 0 or step == args.steps:
            jm, tm = jt.evaluate(), tt.evaluate()
            rec["eval"].append({"step": step, "psnr_jax": jm["psnr"], "psnr_torch": tm["psnr"],
                                "ssim_jax": jm["ssim"], "ssim_torch": tm["ssim"]})
            print(f"[{args.case}] step {step}: loss rel {rec['loss_rel_diff'][-1]:.3g}, "
                  f"psnr jax {jm['psnr']:.4f} torch {tm['psnr']:.4f}, "
                  f"alive {rec['refines'][-1]['n_alive_jax'] if rec['refines'] else '-'} / "
                  f"{rec['refines'][-1]['n_alive_torch'] if rec['refines'] else '-'}, "
                  f"{time.time() - clock:.0f} s", flush=True)
    rec["leaves_end"] = leaf_diffs(jt, tt)
    rel = np.asarray(rec["loss_rel_diff"])
    early = float(rel[:EARLY].max())
    rec["seconds"] = time.time() - clock
    rec["early_max_rel"] = early
    windows = [(s, float(np.median(rel[s:s + 100]))) for s in range(0, len(rel), 100)]
    rec["window_median_rel"] = windows
    rec["first_step_over"] = {str(k): (int(np.argmax(rel > k * early)) + 1
                                       if (rel > k * early).any() else None)
                              for k in (10, 100, 1000)}
    rec["first_refine_count_mismatch"] = next(
        (r["step"] for r in rec["refines"] if not r["counts_equal"]), None)
    return rec


def port_leaf_diffs(a, b) -> dict:
    """leaf_diffs for two port trainers."""
    from splat_tpu_torch.models.convert import named_leaves

    aa, ba = a.params.gaussians.alive > 0.5, b.params.gaussians.alive > 0.5
    out = {"alive_mismatch": int((aa != ba).sum()) if aa.shape == ba.shape else -1}
    both = aa & ba if aa.shape == ba.shape else None
    la, lb = named_leaves(a.params), named_leaves(b.params)
    for name, x in la.items():
        if name.endswith("alive"):
            continue
        x, y = x.detach(), lb[name].detach()
        if x.shape != y.shape:
            out[name] = None
            continue
        if name.startswith("gaussians.") and both is not None:
            x, y = x[both], y[both]
        scale = float(y.abs().max()) if y.numel() else 0.0
        out[name] = float((x - y).abs().max() / scale) if scale > 0 else float((x - y).abs().max())
    return out


def lockstep_self(args, work: Path) -> dict:
    """The rounding control: the port against itself, every leaf of the
    second copy moved by one float32 ulp at the start, the same camera order
    and the same split noise (both copies draw it from generators of one
    seed). How far two runs part from one ulp is how far rounding alone
    carries the JAX-port difference."""
    dataset, session, variant = CASES[args.case]
    make_suites(work / "suite", args.resolution, dataset)
    scene_dir = work / "suite" / "jax" / dataset / session
    _, ta = build_pair(scene_dir, dataset, variant, args.steps, args.seed, args.reset_every,
                       torch_only=True)
    _, tb = build_pair(scene_dir, dataset, variant, args.steps, args.seed, args.reset_every,
                       torch_only=True)
    with torch.no_grad():
        for x in tb.params.gaussians:
            if x.dtype.is_floating_point:
                x.copy_(torch.nextafter(x, torch.full_like(x, float("inf"))))
    n_train = len(ta.train_cams)
    rng = np.random.default_rng(args.seed)
    order = np.concatenate([rng.permutation(n_train)
                            for _ in range(args.steps // n_train + 2)])
    ta._next_camera_index = lambda n: int(order[ta.step])
    tb._next_camera_index = lambda n: int(order[tb.step])
    rec = {"case": args.case, "partner": "port+1ulp", "resolution": args.resolution,
           "steps": args.steps, "seed": args.seed,
           "reset_alpha_every": ta.model_config.reset_alpha_every,
           "loss_a": [], "loss_b": [], "loss_rel_diff": [], "eval": [], "refines": [],
           "leaves": []}
    clock = time.time()
    for step in range(1, args.steps + 1):
        la, lb = ta.run(1)[-1]["loss"], tb.run(1)[-1]["loss"]
        rec["loss_a"].append(la)
        rec["loss_b"].append(lb)
        rec["loss_rel_diff"].append(abs(lb - la) / abs(la))
        if len(ta.refine_events) > len(rec["refines"]):
            ea = ta.refine_events[-1]
            eb = tb.refine_events[-1] if len(tb.refine_events) == len(ta.refine_events) else {}
            rec["refines"].append({"step": step, "a": ea, "b": eb,
                                   "counts_equal": {k: ea[k] for k in ea if k != "step"}
                                   == {k: eb.get(k) for k in ea if k != "step"},
                                   "n_alive_a": int(ta.params.gaussians.alive.sum()),
                                   "n_alive_b": int(tb.params.gaussians.alive.sum()),
                                   "reset": bool(ea.get("reset"))})
            rec["leaves"].append({"step": step, "reset": bool(ea.get("reset")),
                                  **port_leaf_diffs(tb, ta)})
        if step % EVAL_EVERY == 0 or step == args.steps:
            ma, mb = ta.evaluate(), tb.evaluate()
            rec["eval"].append({"step": step, "psnr_a": ma["psnr"], "psnr_b": mb["psnr"]})
            print(f"[{args.case} self] step {step}: loss rel {rec['loss_rel_diff'][-1]:.3g}, "
                  f"psnr {ma['psnr']:.4f} / {mb['psnr']:.4f}, alive "
                  f"{rec['refines'][-1]['n_alive_a'] if rec['refines'] else '-'} / "
                  f"{rec['refines'][-1]['n_alive_b'] if rec['refines'] else '-'}, "
                  f"{time.time() - clock:.0f} s", flush=True)
    rel = np.asarray(rec["loss_rel_diff"])
    rec["seconds"] = time.time() - clock
    rec["early_max_rel"] = float(rel[:EARLY].max())
    rec["leaves_end"] = port_leaf_diffs(tb, ta)
    return rec


def seeds(args, work: Path) -> dict:
    """Each package alone at each seed: the rolling-shutter margin."""
    dataset, session, _ = CASES[args.case]
    make_suites(work / "suite", args.resolution, dataset)
    scene_dir = work / "suite" / "jax" / dataset / session
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        row = {"seed": seed}
        for variant in ("baseline", CASES[args.case][2]):
            for pkg in args.packages.split(","):
                t0 = time.time()
                jt, tt = build_pair(scene_dir, dataset, variant, args.steps, seed,
                                    args.reset_every, jax_only=pkg == "jax",
                                    torch_only=pkg == "torch")
                trainer = jt if pkg == "jax" else tt
                trainer.run(args.steps)
                m = trainer.evaluate()
                row[f"{pkg}_{variant}"] = {"psnr": m["psnr"], "ssim": m["ssim"],
                                           "seconds": time.time() - t0}
                partial = (Path(args.out) / f"seeds_{args.case}_r{args.resolution}_s{seed}_"
                           f"{args.packages.replace(',', '-')}.partial")
                partial.write_text(json.dumps({"steps": args.steps, "rows": rows + [row]}))
                print(f"[seeds] seed {seed} {pkg} {variant}: {m['psnr']:.4f} dB "
                      f"({time.time() - t0:.0f} s)", flush=True)
        v = CASES[args.case][2]
        for pkg in args.packages.split(","):
            row[f"margin_{pkg}"] = row[f"{pkg}_{v}"]["psnr"] - row[f"{pkg}_baseline"]["psnr"]
        rows.append(row)
    return {"case": args.case, "resolution": args.resolution, "steps": args.steps, "rows": rows}


def report(out: Path) -> dict:
    """A summary of every result file under OUT: per lockstep case the loss
    difference in windows, the refines whose counts part, both eval PSNRs and
    the leaves at each reset; per seeds file the margins."""
    summary = {}
    for path in sorted([*out.glob("lockstep_*.json"), *out.glob("self_*.json")]):
        r = json.loads(path.read_text())
        if "psnr_a" in (r["eval"][0] if r["eval"] else {}):
            for e in r["eval"]:
                e["psnr_jax"], e["psnr_torch"] = e["psnr_a"], e["psnr_b"]
            for e in r["refines"]:
                e["n_alive_jax"], e["n_alive_torch"] = e["n_alive_a"], e["n_alive_b"]
        r.setdefault("first_step_over", None)
        rel = np.asarray(r["loss_rel_diff"])
        edges = [0, EARLY, *range(500, len(rel) + 1, 500)]
        if edges[-1] != len(rel):
            edges.append(len(rel))
        summary[path.stem] = {
            "steps": r["steps"], "early_max_rel": r["early_max_rel"],
            "first_step_over": r["first_step_over"],
            "loss_rel_median_by_window": {f"{a + 1}-{b}": float(np.median(rel[a:b]))
                                          for a, b in zip(edges, edges[1:]) if b > a},
            "loss_rel_max": float(rel.max()),
            "refines": [(e["step"], e["n_alive_jax"], e["n_alive_torch"], e["counts_equal"],
                         e["reset"]) for e in r["refines"]],
            "eval": [(e["step"], round(e["psnr_jax"], 4), round(e["psnr_torch"], 4),
                      round(e["psnr_torch"] - e["psnr_jax"], 4)) for e in r["eval"]],
            "leaves_at_resets": [e for e in r["leaves"] if e["reset"]],
            "leaves_end": r.get("leaves_end"),
        }
    margins: dict[str, list] = {}
    for path in sorted(out.glob("seeds_*.json")):
        r = json.loads(path.read_text())
        for row in r["rows"]:
            for key, value in row.items():
                if key.startswith("margin_"):
                    margins.setdefault(key[7:], []).append((row["seed"], round(value, 4)))
        summary[path.stem] = [{k: (round(v["psnr"], 4) if isinstance(v, dict) else v)
                               for k, v in row.items()} for row in r["rows"]]
    for pkg, values in margins.items():
        m = [v for _, v in values]
        summary[f"margin_{pkg}"] = {"by_seed": values, "mean": float(np.mean(m)),
                                    "spread": float(np.max(m) - np.min(m))}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["lockstep", "self", "seeds", "report"])
    ap.add_argument("--case", default="rs", choices=sorted(CASES))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--seeds", default="42,0,1")
    ap.add_argument("--packages", default="jax,torch", help="seeds: which trainers to run")
    ap.add_argument("--reset-every", type=int, default=None,
                    help="refines between opacity resets (the schedule's is 30)")
    ap.add_argument("--work", default=str(ROOT / "_runs" / "long_parity"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "long_parity"))
    args = ap.parse_args(argv)
    if args.steps is None:
        args.steps = 1500 if args.case == "mb" else 3000
    torch.set_num_threads(1)
    work, out = Path(args.work), Path(args.out)
    if args.mode == "report":
        print(json.dumps(report(out), indent=1))
        return 0
    out.mkdir(parents=True, exist_ok=True)
    res = {"lockstep": lockstep, "self": lockstep_self, "seeds": seeds}[args.mode](args, work)
    tag = f"_r{args.resolution}" + (f"_s{args.seeds.replace(',', '-')}_{args.packages.replace(',', '-')}"
                                    if args.mode == "seeds" else "")
    path = out / f"{args.mode}_{args.case}{tag}.json"
    path.write_text(json.dumps(res, indent=1))
    brief = {k: v for k, v in res.items()
             if k not in ("loss_jax", "loss_torch", "loss_rel_diff", "refines", "leaves")}
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
