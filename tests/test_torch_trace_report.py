"""The port's trace report against the JAX package's, on a hand-written trace.

The trace is written as both readers take it: a gzipped chrome trace under
`plugins/profile/run1/` with a device process (`/device:GPU:0`) whose
complete events carry the category `kernel` (or `gpu_memcpy`), as
`torch.profiler`'s `export_chrome_trace` writes them, and a host process
whose events both readers must skip. The JAX module ranks the device
process's events (`device_match="GPU"`), the port's ranks the kernel
categories: the same names, totals, counts and order. The port's timeline
(busy time, idle gaps, busy share) is checked against sums done by hand, and
its report on a real `torch.profiler` trace of CPU work lists no kernel.
"""
import gzip
import json

import pytest
import torch

from splat_tpu.utils import trace_report as j_tr
from splat_tpu_torch.utils import trace_report as t_tr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (name, category, start us, duration us): two overlapping kernels, gaps of
# 5, 30 and 20 us, a copy
DEVICE = [
    ("rasterize_bwd_kernel<5>", "kernel", 0.0, 40.0),
    ("row_gather_vec4", "kernel", 10.0, 5.0),
    ("rasterize_fwd_kernel<5>", "kernel", 45.0, 20.0),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 95.0, 3.0),
    ("seg_copy_vec4", "kernel", 98.0, 2.0),
    ("rasterize_bwd_kernel<5>", "kernel", 120.0, 40.0),
    ("seg_copy_vec4", "kernel", 160.0, 2.0),
]


def _write(tmp_path):
    events = [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:GPU:0"}},
              {"ph": "M", "pid": 7, "name": "process_name", "args": {"name": "python 1234"}}]
    events += [{"ph": "X", "pid": 1, "tid": 7, "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"stream": 7}} for name, cat, ts, dur in DEVICE]
    events += [{"ph": "X", "pid": 7, "tid": 1, "cat": "cpu_op", "name": "aten::add", "ts": 1.0,
                "dur": 500.0, "args": {}},
               {"ph": "X", "pid": 7, "tid": 1, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 2.0, "dur": 4.0, "args": {}},
               {"ph": "i", "pid": 1, "cat": "kernel", "name": "marker", "ts": 3.0}]
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return d / "host.trace.json.gz"


@pytest.mark.parametrize("categories", [("kernel",), ("kernel", "gpu_memcpy", "gpu_memset")])
def test_kernel_table_matches_jax(tmp_path, categories):
    path = _write(tmp_path)
    trace = t_tr.load_trace(path)
    assert trace == j_tr.load_trace(tmp_path)
    jstats = [s for s in j_tr.device_op_stats(trace, device_match="GPU")
              if s.name != "Memcpy HtoD (Pageable -> Device)" or "gpu_memcpy" in categories]
    tstats = t_tr.kernel_stats(trace, categories)
    assert [(s.name, s.total_us, s.count) for s in tstats] == \
        [(s.name, s.total_us, s.count) for s in jstats]
    assert tstats[0].name == "rasterize_bwd_kernel<5>" and tstats[0].mean_us == 40.0


def test_timeline_and_report(tmp_path):
    path = _write(tmp_path)
    tl = t_tr.timeline(t_tr.load_trace(tmp_path))
    # kernels only: [0, 40] (row_gather inside), [45, 65], [98, 100], [120, 162]
    assert tl == {"span_us": 162.0, "busy_us": 40.0 + 20.0 + 2.0 + 42.0, "idle_us": 5.0 + 33.0
                  + 20.0, "gaps": 3, "max_gap_us": 33.0, "busy_share": 104.0 / 162.0}
    text = t_tr.report(path, iters=2, top=3)
    lines = text.splitlines()
    assert lines[0].startswith("device: 0.052 ms/iter busy of a 0.081 ms/iter span "
                               "(busy share 64.2%)")
    assert "in 2 gaps/iter, the longest 33.0 us; 3 kernels/iter (2 iters)" in lines[0]
    assert len(lines) == 2 + 3 and "rasterize_bwd_kernel<5>" in lines[2]
    assert lines[2].split()[:4] == ["40.0", "40.00", "73.4", "1.0"]   # 80 of 109 us
    plain = tmp_path / "trace.json"
    plain.write_text(json.dumps(t_tr.load_trace(path)))
    assert t_tr.report(plain, iters=2, top=3) == text


def test_report_on_a_profiler_trace_of_cpu_work(tmp_path, capsys):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    trace = t_tr.load_trace(tmp_path)
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    assert t_tr.kernel_stats(trace) == []
    t_tr.main([str(tmp_path / "cpu.json")])
    assert "0 kernels/iter" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        t_tr.load_trace(tmp_path / "nothing_here")
