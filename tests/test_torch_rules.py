"""Rules the port keeps: it imports no JAX, nothing of the JAX package and none
of the JAX scripts in `cli/` (its package, `chip_smoke.py` and the
`scripts_dev/*_torch.py` entry points), it
accumulates with no scatter-add outside a kernel's plain version, its entry
points run on the card unless asked for the CPU, and its weights carry across
from the JAX package unchanged."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from splat_tpu.models import splatfacto as jsf
from splat_tpu_torch.device import resolve_device
from splat_tpu_torch.models import splatfacto as tsf
from splat_tpu_torch.models.convert import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX package, and the JAX command-line scripts of cli/ (imported as a
# package or, with cli/ on sys.path, by their module names)
FORBIDDEN = ("jax", "jaxlib", "splat_tpu", "bench", "cli",
             *sorted(p.stem for p in (ROOT / "cli").glob("*.py")))


SCATTER_ADDS = ("index_add_", "index_add", "scatter_add_", "scatter_add", "scatter_reduce_",
                "scatter_reduce")


def _port_files():
    return (sorted((ROOT / "splat_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts_dev").glob("*_torch.py")))


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def _scatter_add_calls(tree):
    """(function name, line) of every accumulating scatter call: the
    index_add / scatter_add / scatter_reduce family, and index_put(_) or
    put_ with accumulate=True."""
    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            name = node.func.attr
            accumulates = any(kw.arg == "accumulate" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value is False)
                for kw in node.keywords)
            if name in SCATTER_ADDS or (name in ("index_put_", "index_put", "put_")
                                        and accumulates):
                yield func, node.lineno
        for child in ast.iter_child_nodes(node):
            yield from visit(child, func)
    yield from visit(tree, None)


@pytest.mark.parametrize("path", sorted((ROOT / "splat_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_scatter_adds_only_in_plain_versions(path):
    """Float atomics make a sum's order change from run to run, so the port
    accumulates by gathers and sorted segments; only a kernel's plain version
    (`*_plain`, sequential on the CPU) may call a scatter-add."""
    calls = list(_scatter_add_calls(ast.parse(path.read_text(), filename=str(path))))
    bad = [(f, line) for f, line in calls if not (f or "").endswith("_plain")]
    assert not bad, f"{path.name}: scatter-add outside a plain version at {bad}"


def test_scatter_add_walk_finds_what_it_should():
    src = ("def f(x, i, v):\n    x.index_put_((i,), v, accumulate=True)\n"
           "    x.index_put_((i,), v)\n    return x.scatter_add(0, i, v)\n"
           "def g_plain(x, i, v):\n    return x.index_add_(0, i, v)\n")
    assert list(_scatter_add_calls(ast.parse(src))) == [("f", 2), ("f", 4), ("g_plain", 6)]


def test_resolve_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_init_model_and_convert_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, size=(300, 3)).astype(np.uint8)
    jc, tc = jsf.SplatfactoConfig(), tsf.SplatfactoConfig()
    jp = jsf.init_model(pts, rgb, 3, 2, jc, seed=5)
    tp = tsf.init_model(pts, rgb, 3, 2, tc, seed=5, device="cpu")
    tree = {"gaussians": {k: np.asarray(v) for k, v in jp.gaussians._asdict().items()},
            "background_logit": np.asarray(jp.background_logit)}
    carried = params_from_numpy(tree, device="cpu")
    for name in tsf.GaussianParams._fields:
        want = np.asarray(getattr(jp.gaussians, name))
        np.testing.assert_array_equal(getattr(tp.gaussians, name).numpy(), want, err_msg=name)
        np.testing.assert_array_equal(getattr(carried.gaussians, name).numpy(), want,
                                      err_msg=name)
    assert carried.camera_opt == {} and tp.camera_opt == {}
