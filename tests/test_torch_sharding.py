"""The port's sweep mesh (``repro_torch/core/sharding.py``) and the sharded
sweep grids (``core/sweep.py`` with ``shard=``).

* The pure helpers against the reference's (``repro/core/sharding.py``) on
  the same inputs: the mesh factorings, padding, the policy-axis and
  sharding decisions under the same switches and a faked device count, and
  the partition specs.
* Policy blocks of ``simulate_stream_core``: 9 policies in 3 blocks against
  the unblocked stream (bit for bit) and against JAX's blocked stream
  (``tests/test_streaming.py``'s RTOL = ATOL = 1e-3).
* The grids of ``tests/test_sharding.py`` (all four entry points, the odd
  fleet axis, ``shard="3d"``, ``block_size=5``, synthesized) run by 8 gloo
  ranks in child processes, held to the single-process grids bit for bit;
  the same grids as every rank's block run in one process.
"""
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import agents as ref_agents
from repro.core import sharding as ref_sharding
from repro.core import simulator as ref_sim
from repro_torch.core import agents, allocator as alloc, capacity, failures, routing
from repro_torch.core import sharding, simulator, workload
from repro_torch.core.agents import synthetic_fleet
from repro_torch.core.sweep import (
    scenario_library, sweep, sweep_capacity, sweep_fleets, sweep_workflows,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_STEPS = 12
POLICIES = ("static_equal", "adaptive", "water_filling")
# Non-divisible on purpose: 5 fleets never divide a 2- or 8-wide mesh axis.
ODD_FLEET_SIZES = (2, 3, 4, 5, 3)
RANKS = 8


# -- pure helpers against the reference --------------------------------------


def test_mesh_factorings_match_the_reference():
    for n in range(1, 65):
        assert sharding.mesh_shape(n) == ref_sharding.mesh_shape(n)
        assert sharding.mesh_shape_3d(n) == ref_sharding.mesh_shape_3d(n)
    for fn in (sharding.mesh_shape, sharding.mesh_shape_3d):
        with pytest.raises(ValueError):
            fn(0)


@pytest.mark.parametrize("shape,axis,multiple", [((3, 4), 0, 4), ((3, 4), 1, 6), ((3, 4), 0, 3),
                                                 ((5, 2, 3), 1, 4), ((1, 7), 0, 8)])
def test_pad_axis_matches_the_reference(shape, axis, multiple):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(ref_sharding.pad_axis(jnp.asarray(x), axis, multiple))
    got = sharding.pad_axis(torch.from_numpy(x), axis, multiple)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sharding.pad_axis(x, axis, multiple), want)
    if x.shape[axis] % multiple == 0:
        t = torch.from_numpy(x)
        assert sharding.pad_axis(t, axis, multiple) is t
    if axis == 0:
        rows = list(range(1, shape[0] + 1))
        assert sharding.pad_axis(rows, 0, multiple) == rows + [1] * (len(want) - len(rows))


def test_pad_tree_axis_matches_the_reference_and_keeps_static_fields():
    fleets = [synthetic_fleet(3, seed=i) for i in range(3)]
    ref_fleets = [ref_agents.synthetic_fleet(3, seed=i) for i in range(3)]
    got = sharding.pad_tree_axis(agents.stack_fleets(fleets), 0, 2)
    want = ref_sharding.pad_tree_axis(ref_agents.stack_fleets(ref_fleets), 0, 2)
    for f in ("model_size_mb", "base_throughput", "min_gpu", "priority", "active"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert got.names == agents.stack_fleets(fleets).names
    spec = workload.stack_specs(workload.scenario_specs(workload.synthetic_rates(4), 5))
    padded = sharding.pad_tree_axis(spec, 0, 3)
    assert padded.gen_id.shape == (9,) and padded.key_data.shape == (9, 2)
    assert padded.rates.shape == (9, 4) and padded.num_steps == spec.num_steps
    np.testing.assert_array_equal(padded.key_data[8], spec.key_data[0])
    chaos = sharding.pad_tree_axis(failures.stack_failures(failures.failure_scenario_library()),
                                   0, 4)
    assert chaos.revoke_frac.shape[0] % 4 == 0 and chaos.key_data.shape[0] % 4 == 0
    assert sharding.pad_tree_axis(None, 0, 2) is None


_SWITCHES = [{}, {"MESH3D": "1"}, {"POLICY": "4"}, {"POLICY": "2", "MESH3D": "1"},
             {"POLICY": "3"}, {"SHARD": "0"}, {"SHARD": "off", "MESH3D": "1"}, {"SHARD": "1"}]


@pytest.mark.parametrize("switches", _SWITCHES, ids=lambda d: ",".join(
    f"{k}={v}" for k, v in d.items()) or "none")
@pytest.mark.parametrize("devices", [1, 2, 7, 8])
def test_sharding_decisions_match_the_reference(monkeypatch, switches, devices):
    """``should_shard``, ``policy_mesh_devices`` and ``shard_env_enabled``
    under the same environment switches and device count as the
    reference's (its ``jax.device_count`` and the port's world size faked)."""
    names = {"SHARD": sharding.SHARD_ENV, "MESH3D": sharding.MESH3D_ENV,
             "POLICY": sharding.POLICY_ENV}
    for env in names.values():
        monkeypatch.delenv(env, raising=False)
    for k, v in switches.items():
        monkeypatch.setenv(names[k], v)
    monkeypatch.setattr(ref_sharding.jax, "device_count", lambda: devices)
    monkeypatch.setattr(sharding, "device_count", lambda: devices)
    assert sharding.shard_env_enabled() == ref_sharding.shard_env_enabled()
    for flag in (None, True, False, "3d"):
        assert sharding.should_shard(flag) == ref_sharding.should_shard(flag), flag
        try:
            want = ref_sharding.policy_mesh_devices(flag)
        except ValueError:
            with pytest.raises(ValueError, match="must divide"):
                sharding.policy_mesh_devices(flag)
            continue
        assert sharding.policy_mesh_devices(flag) == want, flag


def test_device_count_is_one_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert sharding.device_count() == 1
    assert sharding.should_shard(True) is False


@pytest.mark.parametrize("batch_axis", [None, "fleet", "workflow", "capacity", "failure"])
@pytest.mark.parametrize("policy", [False, True])
def test_grid_specs_are_the_reference_partition_specs(batch_axis, policy):
    got_in, got_out = sharding.grid_specs(batch_axis, policy)
    want_in, want_out = ref_sharding.grid_specs(batch_axis, policy)
    assert tuple(got_in) == tuple(tuple(p) for p in want_in)
    assert tuple(got_out) == tuple(want_out)
    assert sharding.MESH_AXES == (ref_sharding.DATA_AXIS, ref_sharding.GRID_AXIS,
                                  ref_sharding.POLICY_AXIS)


@pytest.mark.parametrize("dims", [(2, 2, 2), (2, 4, 1), (1, 2, 4), (3, 1, 1)])
@pytest.mark.parametrize("batch_axis", [None, "fleet"])
def test_blocks_reassemble_the_whole(dims, batch_axis):
    """``shard_block`` at every rank's coordinate, ``assemble``d, is the
    whole tensor under the output spec (policy axis split)."""
    _, spec = sharding.grid_specs(batch_axis, policy=True)
    shape = (4, 24, 3) if batch_axis is None else (6, 4, 8, 3)
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    blocks = [sharding.shard_block(x, spec, dims, sharding.rank_coordinate(r, dims))
              for r in range(int(np.prod(dims)))]
    assert torch.equal(sharding.assemble(blocks, spec, dims), x)


def test_shard_block_refuses_an_unpadded_axis():
    with pytest.raises(ValueError, match="pad it first"):
        sharding.shard_block(torch.zeros(5, 3), (sharding.DATA_AXIS,), (2, 1, 1),
                             sharding.rank_coordinate(0, (2, 1, 1)))


def test_host_device_env():
    env = sharding.host_device_env(4, rank=2, port=29511, base_env={"PATH": "/bin"})
    assert (env["RANK"], env["WORLD_SIZE"], env["MASTER_PORT"]) == ("2", "4", "29511")
    assert env["MASTER_ADDR"] == "127.0.0.1" and env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["PATH"] == "/bin"
    assert int(sharding.host_device_env(2)["MASTER_PORT"]) > 0
    with pytest.raises(ValueError, match="outside"):
        sharding.host_device_env(2, rank=2)
    assert sharding.backend("cpu") == "gloo" and sharding.backend("cuda") == "nccl"


def test_sharded_call_without_a_process_group_raises(monkeypatch):
    """No fallback: with more than one rank claimed but no group to build
    the mesh over, a sharded sweep raises instead of running unsharded."""
    monkeypatch.setattr(sharding, "device_count", lambda: 8)
    fleet = synthetic_fleet(4, seed=0)
    lib = scenario_library(workload.synthetic_rates(4, seed=0), num_steps=4)
    with pytest.raises(RuntimeError, match="process group"):
        sweep(fleet, lib, policies=POLICIES, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        sharding.grid_mesh()
    base = sweep(fleet, lib, policies=POLICIES, device="cpu", shard=False)
    assert base.metrics.shape == (3, 8, len(simulator.METRIC_NAMES))


# -- policy blocks of the stream ---------------------------------------------

ARRIVALS = np.random.default_rng(7).poisson(agents.PAPER_ARRIVAL_RATES, (16, 4)).astype(
    np.float32)


@pytest.mark.parametrize("feature", ["none", "all"])
def test_policy_blocks_match_the_whole_stream_and_jax(feature):
    layers = (lambda r, c, f: {}) if feature == "none" else (lambda r, c, f: {
        "workflow": r.hierarchical(4),
        "capacity": c.capacity_config("reactive", cold_start_s=3.0, min_instances=1.0),
        "failures": f.failure_scenario_library(seed=2)[-1]})
    cfg = {} if feature == "none" else {"num_gpus": 8.0}
    from repro.core import capacity as ref_capacity
    from repro.core import failures as ref_failures
    from repro.core import routing as ref_routing

    names = alloc.policy_names()
    assert len(names) == 9
    run = lambda **kw: simulator.simulate_stream_core(
        torch.from_numpy(ARRIVALS), agents.paper_fleet(), simulator.SimConfig(**cfg), names,
        **layers(routing, capacity, failures), **kw)
    whole = run()
    for k in range(3):
        part = run(num_policy_blocks=3, policy_block=k)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[3 * k:3 * k + 3]), k
        want = ref_sim.simulate_stream_core(
            jnp.asarray(ARRIVALS), ref_agents.paper_fleet(), ref_sim.SimConfig(**cfg), names,
            num_policy_blocks=3, policy_block=k,
            **layers(ref_routing, ref_capacity, ref_failures))
        for a, w in zip(part, want):
            assert a.shape == w.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3)


def test_policy_block_errors_match_the_reference():
    fleet, cfg = agents.paper_fleet(), simulator.SimConfig()
    arr = torch.from_numpy(ARRIVALS)
    with pytest.raises(ValueError, match="do not split"):
        simulator.simulate_stream_core(arr, fleet, cfg, alloc.policy_names(),
                                       num_policy_blocks=2, policy_block=0)
    with pytest.raises(ValueError, match="requires policy_block"):
        simulator.simulate_stream_core(arr, fleet, cfg, alloc.policy_names(),
                                       num_policy_blocks=3)


# -- the grids, sharded -------------------------------------------------------


def _fleet_grid(shard, sizes=ODD_FLEET_SIZES, stream=None, policies=POLICIES,
                synthesize=None, block_size=None):
    fleets = [synthetic_fleet(n, seed=i) for i, n in enumerate(sizes)]
    return sweep_fleets(fleets, num_steps=NUM_STEPS, seed=0, policies=policies, shard=shard,
                        stream=stream, synthesize=synthesize, block_size=block_size,
                        device="cpu").metrics


def _entry_grids(shard, synthesize=None, block_size=None):
    """Metrics from all four entry points under one shard setting, at
    ``tests/test_sharding.py``'s sizes."""
    fleet = synthetic_fleet(4, seed=0)
    rates = workload.synthetic_rates(4, seed=0)
    if synthesize:
        scenarios = workload.scenario_specs(rates, num_steps=NUM_STEPS)
    else:
        scenarios = scenario_library(rates, num_steps=NUM_STEPS)
    kw = dict(policies=POLICIES, shard=shard, synthesize=synthesize, block_size=block_size,
              device="cpu")
    return {
        "sweep": sweep(fleet, scenarios, **kw).metrics,
        "fleets": _fleet_grid(shard, synthesize=synthesize, block_size=block_size),
        "workflows": sweep_workflows(fleet, num_steps=NUM_STEPS, **kw).metrics,
        "capacity": sweep_capacity(fleet, num_steps=NUM_STEPS, **kw).metrics,
    }


def _grids(shard, three_d):
    """Every grid the multi-rank run holds, under one 2D and one 3D mesh
    setting."""
    out = {f"entry_{k}": v for k, v in _entry_grids(shard).items()}
    out.update({f"entry3d_{k}": v for k, v in _entry_grids(three_d).items()})
    out.update({f"synth_{k}": v for k, v in _entry_grids(three_d, synthesize=True,
                                                         block_size=5).items()})
    out["odd"] = _fleet_grid(shard)
    out["odd3d"] = _fleet_grid(three_d)
    out["odd_blocked"] = _fleet_grid(shard, block_size=5)
    out["odd_blocked_synth"] = _fleet_grid(shard, synthesize=True, block_size=5)
    out["odd_trace"] = _fleet_grid(shard, stream=False)
    return out


def _references():
    entry = _entry_grids(False)
    ref = {f"{prefix}_{k}": v for k, v in entry.items() for prefix in ("entry", "entry3d")}
    ref.update({f"synth_{k}": v for k, v in _entry_grids(False, synthesize=True).items()})
    ref["odd"] = ref["odd3d"] = ref["odd_blocked"] = ref["entry_fleets"]
    ref["odd_blocked_synth"] = ref["synth_fleets"]
    ref["odd_trace"] = _fleet_grid(False, stream=False)
    return ref


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_every_ranks_block_in_one_process_equals_the_unsharded_grid():
    """The meshes 8 ranks build, (2, 4, 1) and (2, 2, 2), as tuples: this
    process runs each rank's block and assembles them; bit for bit the
    unsharded grids."""
    _equal(_grids((2, 4, 1), (2, 2, 2)), _references())


_CHILD = """
import numpy as np
import torch.distributed as dist
from repro_torch.core import sharding
sharding.init_process_group("cpu")
assert sharding.device_count() == {ranks}
import tests.test_torch_sharding as t
grids = t._grids(True, "3d")
assert sharding.grid_mesh(policy_devices=2) is sharding.grid_mesh(policy_devices=2)
if dist.get_rank() == {ranks} - 1:
    np.savez({out!r}, **grids)
dist.destroy_process_group()
"""


def test_8_gloo_ranks_match_the_single_process_grids():
    """8 ranks of one gloo group in child processes, each running its
    block of every grid and gathering the others; the last rank's grids
    equal the single-process grids bit for bit."""
    want = _references()
    port = sharding.free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "grids.npz")
        code = _CHILD.format(ranks=RANKS, out=out)
        procs = []
        for rank in range(RANKS):
            env = sharding.host_device_env(RANKS, rank=rank, port=port)
            env["PYTHONPATH"] = os.pathsep.join(
                [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        results = []
        try:
            for p in procs:
                results.append(p.communicate(timeout=300))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
            assert p.returncode == 0, (rank, stdout, stderr[-3000:])
        got = dict(np.load(out))
    _equal(got, want)
