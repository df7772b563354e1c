"""The port's copy of the spatial partition planner
(repro_torch.distributed.partition) against the reference's."""
import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.distributed import partition as jax_partition  # noqa: E402
from repro_torch.core.agents import PAPER_ARRIVAL_RATES, paper_fleet  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402

FLEET = paper_fleet()
MIN_GPU = FLEET.min_gpu.numpy().astype(np.float64)
PRIORITY = FLEET.priority.numpy().astype(np.float64)


def _same(lam, mins, pri, chips):
    got = partition.plan_partition(lam, mins, pri, chips)
    want = jax_partition.plan_partition(lam, mins, pri, chips)
    assert (got.chips, got.fractions, got.total_chips) == (
        want.chips, want.fractions, want.total_chips)
    return got


@pytest.mark.parametrize("chips", (1, 2, 3, 8, 64, 256, 512))
@pytest.mark.parametrize("lam", (PAPER_ARRIVAL_RATES, (0.0, 0.0, 0.0, 0.0), (5.0, 0.0, 1.0, 0.0),
                                 (100.0, 1.0, 1.0, 1.0)))
def test_paper_fleet_plans_equal_reference(lam, chips):
    p = _same(np.asarray(lam, np.float64), MIN_GPU, PRIORITY, chips)
    assert sum(p.chips) == (chips if sum(lam) > 0 else 0)


def test_paper_fleet_on_256_chips():
    p = partition.plan_partition(np.asarray(PAPER_ARRIVAL_RATES), MIN_GPU, PRIORITY, 256)
    np.testing.assert_allclose(p.chips, [61, 65, 54, 76], atol=1)


@hypothesis.given(
    lam=st.lists(st.floats(0, 1e3), min_size=2, max_size=12),
    chips=st.sampled_from([1, 4, 8, 64, 256, 512]),
    seed=st.integers(0, 100),
)
@hypothesis.settings(max_examples=150, deadline=None)
def test_plans_equal_reference(lam, chips, seed):
    n = len(lam)
    rng = np.random.default_rng(seed)
    mins = rng.uniform(0.01, 1.0 / n, n)
    pri = rng.integers(1, 4, n).astype(float)
    p = _same(np.asarray(lam), mins, pri, chips)
    if sum(lam) > 0 and chips >= n:
        assert sum(p.chips) == chips
        assert all(c >= 1 for li, c in zip(lam, p.chips) if li > 0)


@hypothesis.given(
    cur=st.lists(st.integers(0, 64), min_size=2, max_size=6),
    new=st.lists(st.integers(0, 64), min_size=2, max_size=6),
    tput=st.lists(st.floats(0, 1e4), min_size=6, max_size=6),
    gain=st.sampled_from([0.0, 0.05, 0.10, 0.5]),
)
@hypothesis.settings(max_examples=150, deadline=None)
def test_should_repartition_equals_reference(cur, new, tput, gain):
    n = min(len(cur), len(new))
    cur, new, t = cur[:n], new[:n], np.asarray(tput[:n])
    plans = []
    for mod in (partition, jax_partition):
        a = mod.PartitionPlan(tuple(cur), (0.0,) * n, max(sum(cur), 1))
        b = mod.PartitionPlan(tuple(new), (0.0,) * n, max(sum(new), 1))
        plans.append(mod.should_repartition(a, b, t, gain))
    assert plans[0] == plans[1]


def test_repartition_hysteresis():
    t = np.asarray([100.0, 30.0])
    cur = partition.PartitionPlan((128, 128), (0.5, 0.5), 256)
    slightly = partition.PartitionPlan((140, 116), (0.55, 0.45), 256)
    much = partition.PartitionPlan((240, 16), (0.94, 0.06), 256)
    assert not partition.should_repartition(cur, slightly, t)
    assert partition.should_repartition(cur, much, t)
