"""The harness on the CPU: BENCHMARK.json against the contract's limits and
the files it names, the result line of a run at a tiny size, a metric found
by its file alone, the configurations against the program's variant flags,
and the exit without a card."""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

from .tiny import run_tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_benchmark_json_keys_and_characters():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"] and all(LINE.match(w) for w in BENCH["command"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names)) and "setup_s" in names


def test_benchmark_json_matches_the_cell_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert list(cells) == ["phone_mbrs.train"]
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in BENCH["configs"]}
    for name, w in cells.items():
        cell = harness.load("workloads", name)
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                  w["chips"])
        mine = {m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])}
        assert set(cell["end_to_end"]) == mine - {"setup_s"}
        mix = harness.load("traffic", cell["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{mix['kind']}.py").is_file()


@pytest.mark.parametrize("name", sorted(p.stem for p in (ROOT / "perfbench" / "workloads")
                                        .glob("*.json")))
def test_every_cell_file_names_files_that_are_there(name):
    """Cells defined beside those BENCHMARK.json holds (PERF.md, open
    questions) stay runnable: their configuration, mix and traffic kind."""
    cell = harness.load("workloads", name)
    config = harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    assert (ROOT / "perfbench" / "traffic" / f"{mix['kind']}.py").is_file()
    assert config["scene"]["width"] > 0 and set(cell["limits"]) and cell["chips"] in (1, 4)


def test_every_cell_reports_setup_an_end_to_end_metric_and_a_per_layer_metric():
    from perfbench.run import per_layer_metrics

    e2e = BENCH["end_to_end"]
    for w in BENCH["workloads"]:
        cell = w["name"]
        mine = {m["name"] for m in e2e if cell in m.get("workloads", [cell])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = per_layer_metrics(cell, BENCH)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (cell, m["name"])
    for m in BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            moved = next(x for x in e2e if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    out, lines = run_tiny("phone_mbrs.train", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace
                                                                     else [])
    assert list(out) == keys + ["checks"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in out["device"] and "busy_s" in out["device"]
        assert set(out["metrics"]) <= {"train_mfu", "compositing_roofline.train",
                                       "launches_per_step.train", "device_idle.train"}
    else:
        assert set(out["metrics"]) == {"train_steps_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert [line.split(":")[0] for line in lines[1:]] == ["check loss", "check grad",
                                                         "check change"]
    json.dumps(out)


def test_view_frames_are_each_timed():
    """The view cell's latencies: one a frame, every frame of the window."""
    from perfbench.traffic import view

    out, _ = run_tiny("phone_mbrs.view")
    assert out["correct"] is True
    res = {"latency_s": [0.01 * (i + 1) for i in range(100)]}
    q = view.end_to_end(res)
    assert q["ms_p50"] == pytest.approx(505.0) and q["ms_p95"] == pytest.approx(950.5)


def test_a_metric_is_found_by_its_file_alone():
    name = "zz_dummy_for_test"
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    path.write_text("def read(ctx):\n    return 1.5 + ctx.traced['frames'] * 0\n")
    try:
        bench = json.loads(json.dumps(BENCH))
        bench["per_layer"].append({"name": name, "unit": "x", "better": "lower",
                                   "source": "program_counter", "layer": "model",
                                   "moves": "render_ms_p50", "workloads": ["phone_mbrs.view"]})
        out, _ = run_tiny("phone_mbrs.view", trace=True, bench=bench)
        assert out["metrics"][name] == {"value": 1.5, "unit": "x"}
    finally:
        path.unlink()


def test_configurations_carry_the_programs_variant_flags():
    from splat_tpu_torch.cli.train import dataset_params, flags_to_variant_name_and_cmd

    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        features = set(config["variant"].split("-")) - {"baseline"}
        name, flags = flags_to_variant_name_and_cmd(features, config["dataset"], False)
        assert name == config["variant"] and flags == config["flags"]
        dp = dataset_params(config["dataset"])
        assert config["data_flags"][:3] == ["nerfstudio-data", "--eval-mode", dp["eval_mode"]]


def test_reference_reads_the_flags_as_the_program_does():
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        ref, tc = harness.reference_configs(config, 5)
        prog, ptc = harness.program_configs(config, 5, "cpu")
        for f in dataclasses.fields(ref):
            a, b = getattr(ref, f.name), getattr(prog, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        for k, v in tc.items():
            assert getattr(ptc, k) == v, k


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "phone_mbrs.train",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr
