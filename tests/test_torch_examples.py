"""The port's examples (``examples/*_torch.py``) and the public names they
and the reference's examples use.

Each example's ``main`` runs in this process with ``--device cpu`` at a
reduced size (serving 2 ticks, training 3 steps); quickstart's printed
rows equal the JAX example's.  Each name the port adds for the reference's
public surface (``static_equal``, ``round_robin``, ``independent_workflow``,
``failure_names``, ``is_decl``, ``tree_map_decls``, ``count_params``)
gives the reference's values on the same inputs.
"""
import contextlib
import importlib.util
import io
import math
import pathlib
import runpy

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "profile_driven_fleet", "robustness_study", "serve_fleet",
            "train_small")


def _example(name):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = _example(name).main(["--device", "cpu", *argv])
    return result, out.getvalue()


def test_every_example_has_a_port():
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")
                  if not p.stem.endswith("_torch")) == sorted(EXAMPLES)
    for name in EXAMPLES:
        assert callable(_example(name).main)


def test_quickstart_prints_the_reference_rows():
    rows, printed = _run("quickstart")
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    assert printed == ref.getvalue()
    assert round(rows["static_equal"].avg_latency, 1) == 110.3
    assert round(rows["adaptive"].avg_latency, 1) == 111.9
    assert round(rows["adaptive"].total_throughput, 2) == 58.12
    assert {round(r.cost, 3) for r in rows.values()} == {0.020}


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example("quickstart").main([])


def test_robustness_study():
    table, printed = _run("robustness_study", "--steps", "30")
    assert set(table) == {"steady", "overload_3x", "spike_10x", "diurnal", "poisson"}
    assert "throughput (rps):" in printed and len(printed.splitlines()) == 13
    for row in table.values():
        for s in row.values():
            assert math.isfinite(s.avg_latency) and s.total_throughput > 0


def test_profile_driven_fleet():
    out, printed = _run("profile_driven_fleet", "--steps", "30")
    assert set(out["profiles"]) == {"qwen2-vl-2b", "granite-8b", "mixtral-8x7b", "llama3-405b"}
    for p in out["profiles"].values():
        assert p["throughput_tokens_per_s"] > 0 and 0.02 <= p["min_gpu"] <= 0.9
    assert all(math.isfinite(s.avg_latency) for s in out["rows"].values())
    assert "bottleneck=" in printed


def test_serve_fleet():
    results, printed = _run("serve_fleet", "--ticks", "2")
    assert set(results) == {"adaptive", "round_robin"}
    assert "== adaptive ==" in printed and "== round_robin ==" in printed
    for m in results.values():
        assert m["completed"] >= 0 and "avg_latency_ticks" in m


def test_train_small():
    out, printed = _run("train_small", "--steps", "3")
    assert out["last"] < out["first"] and math.isfinite(out["restored_loss"])
    assert "checkpoint roundtrip" in printed


# -- the public names ----------------------------------------------------------


@pytest.mark.parametrize("num_agents,g_total", [(1, 1.0), (4, 1.0), (7, 0.3), (256, 2.5)])
def test_static_equal_and_round_robin_match_the_reference(num_agents, g_total):
    from repro.core import allocator as ref_alloc
    from repro_torch.core import allocator as alloc

    np.testing.assert_array_equal(alloc.static_equal(num_agents, g_total, device="cpu").numpy(),
                                  np.asarray(ref_alloc.static_equal(num_agents, g_total)))
    for t in (0, 1, 5, 2 ** 24 + 3):
        np.testing.assert_array_equal(
            alloc.round_robin(t, num_agents, g_total, device="cpu").numpy(),
            np.asarray(ref_alloc.round_robin(jnp.asarray(t), num_agents, g_total)), err_msg=t)


def test_package_exports_match_the_reference():
    import repro.core as ref_core
    import repro_torch.core as core
    from repro_torch.core import allocator as alloc, routing

    for name in ("static_equal", "round_robin", "independent_workflow"):
        assert name in core.__all__ and name in ref_core.__all__
    assert core.static_equal is alloc.static_equal and core.round_robin is alloc.round_robin
    assert core.independent_workflow is routing.independent_workflow


@pytest.mark.parametrize("n", [1, 4, 9])
def test_independent_workflow_matches_the_reference(n):
    from repro.core import routing as ref_routing
    from repro_torch.core import routing

    got, want = routing.independent_workflow(n), ref_routing.independent_workflow(n)
    assert got.name == want.name
    for f in ("route", "source", "sink", "fan_out"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    with pytest.raises(ValueError):
        routing.independent_workflow(0)


def test_failure_names_match_the_reference():
    from repro.core import failures as ref_failures
    from repro_torch.core import failures

    assert failures.failure_names() == ref_failures.failure_names()


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b", "mamba2-370m",
                                  "recurrentgemma-9b", "seamless-m4t-large-v2"])
def test_param_decl_helpers_match_the_reference(arch):
    """``count_params``, and ``tree_map_decls`` over every declaration with
    ``is_decl`` true at each leaf, on one reduced architecture of each
    family (the port keeps a list per layer where the reference stacks a
    leading axis, so the counts, not the shapes, are compared)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import model as jax_model
    from repro.models import params as ref_params
    from repro_torch.configs import get_config
    from repro_torch.models import model, params

    decls = model.build_model(get_config(arch, reduced=True)).param_decls
    ref_decls = jax_model.build_model(jax_get_config(arch, reduced=True)).param_decls
    assert params.count_params(decls) == ref_params.count_params(ref_decls)
    sizes = params.tree_leaves(params.tree_map_decls(lambda d: math.prod(d.shape), decls))
    ref_sizes = jax.tree_util.tree_leaves(
        ref_params.tree_map_decls(lambda d: math.prod(d.shape), ref_decls))
    assert sum(sizes) == sum(ref_sizes) == params.count_params(decls)
    assert all(params.tree_leaves(params.tree_map_decls(params.is_decl, decls)))
    assert not params.is_decl((4, 4)) and not ref_params.is_decl((4, 4))
