"""The port's densification strategy against the JAX package on the CPU.

`refine` against `make_refine` on the same numpy state. The JAX function
draws its split offsets from its PRNG key; the test draws the same two
samples with `jax.random` (the key split and the fold-in of
`splat_tpu/models/strategy.py`) and hands them to the port. Opacities, scales
and mean gradients sit well away from their thresholds, so no decision hangs
on a last bit. Tolerances: masks, `changed`, the `info` counts and `alive`
equal; floats rtol 1e-6 (the split offsets go through exp, a quaternion
rotation and a 3x3 product in each package). `reset_opacity`,
`grow_capacity` and `grow_strategy_state` exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_tpu.models import splatfacto as jsf
from splat_tpu.models import strategy as jst
from splat_tpu_torch.models import splatfacto as tsf
from splat_tpu_torch.models import strategy as tst

C = 64
FIELDS = tsf.GaussianParams._fields
CFG = dict(warmup_length=10, refine_every=10, stop_split_at=1000, densify_grad_thresh=0.002,
           densify_size_thresh=0.01, cull_alpha_thresh=0.1, cull_scale_thresh=0.5)


def _state(n_alive, low_opacity=(), scales=0.004, huge=(), hot=(), seed=0):
    """A capacity-C cloud with the first n_alive slots alive. low_opacity:
    slots below the cull threshold; scales: the common scale (small: clone,
    large: split); huge: slots above the cull scale; hot: slots whose mean
    screen gradient passes the densify threshold."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    g = {
        "means": rng.normal(size=(C, 3)).astype(f32),
        "scales_log": (np.log(scales) + rng.uniform(-0.2, 0.2, size=(C, 3))).astype(f32),
        "quats": rng.normal(size=(C, 4)).astype(f32),
        "opacities_logit": np.full(C, 2.0, f32),
        "features_dc": rng.normal(size=(C, 3)).astype(f32),
        "features_rest": rng.normal(size=(C, 3, 3)).astype(f32),
        "alive": (np.arange(C) < n_alive).astype(f32),
    }
    # a few dead slots among the alive ones, so dead-slot ranks are not a suffix
    g["alive"][[3, 11]] = 0.0
    g["opacities_logit"][list(low_opacity)] = -4.0
    g["scales_log"][list(huge)] = np.log(0.9)
    count = rng.integers(1, 9, size=C).astype(np.int32)
    count[5] = 0
    accum = (count * 0.0002).astype(f32)
    accum[list(hot)] = (np.maximum(count[list(hot)], 1) * 0.02).astype(f32)
    return g, accum, count


CASES = {
    # before the warm-up ends: transparent Gaussians go, nothing is added
    "cull_only": dict(step=5, state=dict(n_alive=40, low_opacity=(0, 7, 8, 30), hot=(1, 2))),
    "clone_only": dict(step=20, state=dict(n_alive=40, scales=0.004, hot=(1, 2, 9, 20, 39))),
    "split_only": dict(step=20, state=dict(n_alive=40, scales=0.05, hot=(0, 2, 9, 20, 39))),
    "mixed_with_scale_cull": dict(step=20, state=dict(n_alive=50, scales=0.05, huge=(4, 6),
                                                      low_opacity=(7,), hot=(1, 2, 6, 7, 44))),
    # 60 alive + 2 holes: 6 dead slots (one more from a cull) for 12 candidates
    "overflow_dead_slots": dict(step=20, state=dict(n_alive=60, scales=0.05, low_opacity=(50,),
                                                    hot=tuple(range(12, 36, 2)))),
    "past_stop_split": dict(step=2000, state=dict(n_alive=40, scales=0.05, hot=(1, 2))),
}


def _both(case):
    spec = CASES[case]
    g, accum, count = _state(**spec["state"])
    jcfg, tcfg = jsf.SplatfactoConfig(**CFG), tsf.SplatfactoConfig(**CFG)
    key = jax.random.PRNGKey(11)
    jparams = jsf.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()})
    jstate = jst.StrategyState(jnp.asarray(accum), jnp.asarray(count), key)
    j_out = jst.make_refine(jcfg)(jparams, jstate, jnp.asarray(spec["step"]))
    # the draws of make_refine
    _, k_split = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_split, (C, 3)))
    eps2 = np.asarray(jax.random.normal(jax.random.fold_in(k_split, 1), (C, 3)))
    tparams = tsf.GaussianParams(**{k: torch.tensor(v, requires_grad=(k != "alive"))
                                    for k, v in g.items()})
    tstate = tst.init_strategy_state(C, device="cpu")._replace(
        grad_accum=torch.tensor(accum), grad_count=torch.tensor(count))
    t_out = tst.refine(tparams, tstate, spec["step"], tcfg, (torch.tensor(eps), torch.tensor(eps2)))
    return g, j_out, t_out


@pytest.mark.parametrize("case", sorted(CASES))
def test_refine_matches_jax(case):
    g, (jg, jstate, jchanged, jinfo), (tg, tstate, tchanged, tinfo) = _both(case)
    info = {k: int(v) for k, v in tinfo.items()}
    assert info == {k: int(v) for k, v in jinfo.items()}
    np.testing.assert_array_equal(tchanged.numpy(), np.asarray(jchanged))
    np.testing.assert_array_equal(tg.alive.numpy(), np.asarray(jg.alive))
    for f in FIELDS:
        got = getattr(tg, f)
        assert not got.requires_grad, f
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jg, f)), rtol=1e-6, atol=0,
                                   err_msg=f)
    assert not tstate.grad_accum.any() and not tstate.grad_count.any()
    assert tstate.grad_count.dtype == torch.int32
    n_alive0 = int(g["alive"].sum())
    assert info["n_alive"] == n_alive0 - info["n_culled"] + info["n_split"] + info["n_cloned"]
    # what each case is there to show
    if case == "cull_only":
        assert info["n_culled"] == 4 and info["n_split"] == info["n_cloned"] == 0
    elif case == "clone_only":
        assert info["n_cloned"] == 5 and info["n_split"] == info["n_culled"] == 0
    elif case == "split_only":
        assert info["n_split"] == 5 and info["n_cloned"] == info["n_culled"] == 0
        moved = np.abs(tg.means.numpy() - g["means"]).max(axis=1) > 0
        assert moved.sum() == 10, "five originals moved, five dead slots filled"
    elif case == "mixed_with_scale_cull":
        assert info["n_culled"] == 3 and info["n_split"] == 3
    elif case == "overflow_dead_slots":
        assert info["n_split"] == 7 and info["n_alive"] == C, "trimmed to the dead slots"
    elif case == "past_stop_split":
        assert info["n_split"] == info["n_cloned"] == 0


def test_rank_match_puts_rth_candidate_in_rth_dead_slot():
    g, _, _ = _state(n_alive=40)
    params = tsf.GaussianParams(**{k: torch.tensor(v) for k, v in g.items()})
    new_vals = params._replace(means=params.means + 100.0)
    want = torch.zeros(C, dtype=torch.bool)
    want[[2, 9, 30]] = True
    out, filled = tst._rank_match_scatter(params, new_vals, want)
    dead = [3, 11] + list(range(40, C))
    assert filled.nonzero().reshape(-1).tolist() == dead[:3]
    for src, dst in zip([2, 9, 30], dead[:3]):
        assert torch.equal(out.means[dst], new_vals.means[src])
        assert out.alive[dst] == 1.0
    untouched = ~filled
    assert torch.equal(out.means[untouched], params.means[untouched])
    jparams = jsf.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()})
    jout, jfilled = jst._rank_match_scatter(
        jparams, jparams._replace(means=jparams.means + 100.0), jnp.asarray(want.numpy()))
    np.testing.assert_array_equal(filled.numpy(), np.asarray(jfilled))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jout, f)))


def test_reset_opacity_matches_jax():
    g, _, _ = _state(n_alive=40)
    g["opacities_logit"] = np.linspace(-6.0, 6.0, C).astype(np.float32)
    for thresh in (0.1, 0.005, 0.6):
        jcfg = jsf.SplatfactoConfig(cull_alpha_thresh=thresh)
        tcfg = tsf.SplatfactoConfig(cull_alpha_thresh=thresh)
        want = jst.make_reset_opacity(jcfg)(
            jsf.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}))
        got = tst.reset_opacity(tsf.GaussianParams(**{k: torch.tensor(v) for k, v in g.items()}),
                                tcfg)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        assert got.opacities_logit.max() < g["opacities_logit"].max()


@pytest.mark.parametrize("new_capacity", [128, 64, 32])
def test_grow_capacity_and_strategy_state_match_jax(new_capacity):
    g, accum, count = _state(n_alive=40)
    want = jst.grow_capacity(jsf.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                             new_capacity)
    got = tst.grow_capacity(tsf.GaussianParams(**{k: torch.tensor(v) for k, v in g.items()}),
                            new_capacity)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.alive.shape[0] == max(new_capacity, C)
    jstate = jst.grow_strategy_state(
        jst.StrategyState(jnp.asarray(accum), jnp.asarray(count), jax.random.PRNGKey(0)),
        new_capacity)
    tstate = tst.init_strategy_state(C, seed=4, device="cpu")._replace(
        grad_accum=torch.tensor(accum), grad_count=torch.tensor(count))
    grown = tst.grow_strategy_state(tstate, new_capacity)
    np.testing.assert_array_equal(grown.grad_accum.numpy(), np.asarray(jstate.grad_accum))
    np.testing.assert_array_equal(grown.grad_count.numpy(), np.asarray(jstate.grad_count))
    assert grown.grad_count.dtype == torch.int32
    assert grown.generator is tstate.generator, "growth must not rewind the split sampling"
