"""The dry-run and roofline on a mesh: the step as DTensors on ``meta`` over
a ``fake`` process group (``repro_torch/launch/dryrun.py``,
``launch/roofline.py``, ``launch/mesh.py``), and the kernels' sharded routes.

* On a mesh of size-1 axes the sharded count is the one-card count: flops,
  bytes, peak and kernel calls equal, no collective (every arch serving,
  one of each family training).
* One product with an FSDP-gathered weight: the all-gather's bytes and the
  local flops by hand.
* On a ("data",) mesh of 4 every product of a batch-sharded step has 1/4 of
  its one-card flops.
* The same sharded count twice in one process gives the same numbers (the
  sharding propagator's ops are not counted).
* Without a mesh the numbers are the ones the dry-run gave before the mesh
  existed, bit for bit (``tests/torch_dryrun_one_card.json``).
* The kernels count ``cost`` at their local shapes and raise on a placement
  they do not handle.
* Units x trips equal the whole step on a mesh, collective bytes included;
  the CLIs take ``--multi-pod``/``--rules``.

The fake group is process-global: the module fixture destroys it, so that
the gloo groups of other test files never meet it on the same worker.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.distributed.tensor.placement_types import Partial  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels._common import counting_costs  # noqa: E402
from repro_torch.kernels.attention import decode_attention as da  # noqa: E402
from repro_torch.kernels.attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ssd import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline  # noqa: E402
from repro_torch.models.model import InputShape  # noqa: E402
from repro_torch.models.params import abstract_dtensor  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MODES = ("train", "prefill", "decode")
SMALL = {mode: InputShape("t", 32, 2, mode) for mode in MODES}


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    mesh.init_fake_group()
    yield
    mesh._fake_meshes.clear()
    dist.destroy_process_group()


def _rules(mode):
    return sharding.RULE_SETS[dryrun.default_rules(InputShape("t", 1, 1, mode))]


def _dmesh(*sizes, names=None):
    names = names or ("data", "model", "pod")[:len(sizes)]
    return mesh.device_mesh(mesh.MeshDesc(tuple(names), tuple(sizes)), "fake")


# Every arch serving; one arch of each family (and the vision stub) training.
UNIT_CASES = ([(arch, mode) for arch in ARCH_IDS for mode in ("prefill", "decode")]
              + [(arch, "train") for arch in ("granite-8b", "qwen2-vl-2b", "mixtral-8x7b",
                                              "mamba2-370m", "recurrentgemma-9b",
                                              "seamless-m4t-large-v2")])


@pytest.mark.parametrize("arch,mode", UNIT_CASES)
def test_unit_mesh_counts_as_one_card(arch, mode):
    cfg = get_config(arch, reduced=True)
    one = dryrun.measure(cfg, SMALL[mode])
    got = dryrun.measure(cfg, SMALL[mode], None, _dmesh(1, 1), _rules(mode))
    assert got["collective_bytes"]["total"] == 0 and got["collective_bytes"]["count"] == 0
    assert got["work"]["flops"] == one["work"]["flops"]
    assert got["work"]["bytes"] == one["work"]["bytes"]
    assert got["peak_bytes"] == one["peak_bytes"]
    assert got["argument_bytes"] == one["argument_bytes"]
    assert got["kernels"] == one["kernels"]


def test_fsdp_gathered_product_by_hand():
    """x (32, 64) batch-sharded over 4, w (64, 128) embed-sharded (rows over
    "data"): the weight is all-gathered once (64·128·2 bytes out per
    device) and the product is local, 2·8·64·128 flops."""
    d = _dmesh(4, names=("data",))
    x = abstract_dtensor(d, (Shard(0),), (32, 64), torch.bfloat16)
    w = abstract_dtensor(d, (Shard(0),), (64, 128), torch.bfloat16)
    fn = dryrun.sharded(lambda a, b: a @ sharding.gather_weights(b), d, sharding.TRAIN_RULES)
    counter, out, _ = dryrun.count(fn, x, w, dmesh=d)
    coll = counter.collective_bytes()
    assert coll["all-gather"] == 64 * 128 * 2 and coll["count"] == 1 and coll["total"] == coll[
        "all-gather"]
    assert coll["by_axis"] == {"data": 64 * 128 * 2}
    assert counter.flops == {torch.bfloat16: 2 * 8 * 64 * 128}
    assert out.placements == (Shard(0),) and out.to_local().shape == (8, 128)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ("granite-8b", "qwen2-vl-2b", "mamba2-370m"))
def test_batch_sharded_step_has_a_quarter_of_the_flops(arch, mode):
    """On ("data",) x 4 with a batch of 8: every product (and every kernel's
    cost) is batch-local, so the device's flops are the one card's / 4."""
    cfg, shape = get_config(arch, reduced=True), InputShape("t", 32, 8, mode)
    one = dryrun.measure(cfg, shape)
    got = dryrun.measure(cfg, shape, None, _dmesh(4, names=("data",)), _rules(mode))
    assert {dt: 4 * f for dt, f in got["work"]["flops"].items()} == one["work"]["flops"]
    assert got["kernels"] == one["kernels"]
    assert got["collective_bytes"]["by_axis"].keys() == {"data"}


@pytest.mark.parametrize("arch,mode", [("mamba2-370m", "train"), ("granite-8b", "decode"),
                                       ("mixtral-8x7b", "prefill")])
def test_counting_twice_gives_the_same_numbers(arch, mode):
    """The first count of a step fills DTensor's propagation caches (and runs
    decompositions on global shapes); the second hits them.  Both count the
    same (mamba's softplus backward has no DTensor strategy)."""
    cfg, shape = get_config(arch, reduced=True), InputShape("t", 32, 8, mode)
    d = _dmesh(2, 2)
    first, second = (dryrun.measure(cfg, shape, None, d, _rules(mode)) for _ in range(2))
    assert first == second


def test_one_card_numbers_are_unchanged():
    """Every reduced architecture at 2 x 32 in each mode: flops by dtype,
    bytes, peak, argument and output bytes and kernel calls as the one-card
    dry-run counted them before the mesh was added
    (``torch_dryrun_one_card.json``, written by that version's
    ``dryrun.measure``)."""
    with open(os.path.join(HERE, "torch_dryrun_one_card.json")) as f:
        want = json.load(f)
    assert len(want) == 3 * len(ARCH_IDS)
    for arch in ARCH_IDS:
        for mode in MODES:
            m = dryrun.measure(get_config(arch, reduced=True), SMALL[mode])
            got = {"flops": {str(k): v for k, v in m["work"]["flops"].items()},
                   "bytes": m["work"]["bytes"], "peak": m["peak_bytes"],
                   "arg": m["argument_bytes"], "out": m["output_bytes"], "kernels": m["kernels"]}
            assert got == want[f"{arch}/{mode}"], (arch, mode)


def test_kernels_count_their_local_shapes():
    """granite-8b's 32/8 heads over a 16-way model axis: flash with head-
    sharded q and replicated K/V counts the cost of 2 heads over 1 kv head;
    decode over a 16-way slot shard counts one shard's 256 entries with the
    log-sum-exp; the SSD scan over a 4-way batch shard counts a quarter of
    the batch."""
    d = _dmesh(1, 16)
    b, s, d_h = 4, 256, 128
    calls = []

    class Costs:
        def add_kernel(self, name, cost):
            calls.append((name, cost))

    q = abstract_dtensor(d, (Replicate(), Shard(2)), (b, s, 32, d_h), torch.bfloat16)
    k = abstract_dtensor(d, (Replicate(), Replicate()), (b, s, 8, d_h), torch.bfloat16)
    qd = abstract_dtensor(d, (Replicate(), Replicate()), (b, 32, d_h), torch.bfloat16)
    kc = abstract_dtensor(d, (Replicate(), Shard(1)), (b, 4096, 8, d_h), torch.bfloat16)
    with counting_costs(Costs()):
        out = fa.flash_attention(q, k, k, causal=True)
        dec = da.decode_attention(qd, kc, kc, 4096)
    assert out.placements == q.placements and out.to_local().shape == (b, s, 2, d_h)
    assert dec.placements == (Replicate(), Replicate())
    assert calls[0] == ("flash_attention", fa.cost(b, s, s, 2, 1, d_h, causal=True, window=0,
                                                   q_offset=0, dtype=torch.bfloat16))
    # The fake group's rank is 0: the first slot shard, 256 entries, all valid.
    assert calls[1] == ("decode_attention", da.cost(b, 32, 8, d_h, 256, 4096, window=0,
                                                    dtype=torch.bfloat16, lse=True))
    d4 = _dmesh(4, names=("data",))
    x = abstract_dtensor(d4, (Shard(0),), (8, 128, 8, 64), torch.bfloat16)
    dt = abstract_dtensor(d4, (Shard(0),), (8, 128, 8), torch.float32)
    a_ = abstract_dtensor(d4, (Replicate(),), (8,), torch.float32)
    bm = abstract_dtensor(d4, (Shard(0),), (8, 128, 32), torch.bfloat16)
    calls.clear()
    with counting_costs(Costs()):
        y, h = ssd_scan.ssd(x, dt, a_, bm, bm, a_, chunk=64)
    assert y.to_local().shape == (2, 128, 8, 64) and h.to_local().shape == (2, 8, 64, 32)
    assert calls == [("ssd", ssd_scan.cost(2, 128, 8, 64, 32, chunk=64, h0=False,
                                           dtype=torch.bfloat16))]


def test_unhandled_placements_raise():
    """A q sharded on its head dim, an SSD x with a pending sum, a cache
    sharded on its head dim: the sharded routes raise rather than gather."""
    d = _dmesh(1, 4)
    q = abstract_dtensor(d, (Replicate(), Shard(3)), (2, 64, 8, 64), torch.bfloat16)
    k = abstract_dtensor(d, (Replicate(), Replicate()), (2, 64, 2, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="flash_attention"):
        fa.flash_attention(q, k, k)
    qd = abstract_dtensor(d, (Replicate(), Replicate()), (2, 8, 64), torch.bfloat16)
    kc = abstract_dtensor(d, (Replicate(), Shard(3)), (2, 64, 2, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="decode_attention"):
        da.decode_attention(qd, kc, kc, 64)
    x = abstract_dtensor(d, (Replicate(), Replicate()), (2, 64, 4, 64), torch.bfloat16)
    xp = DTensor.from_local(x.to_local(), d, (Replicate(), Partial()), run_check=False)
    dt = abstract_dtensor(d, (Replicate(), Replicate()), (2, 64, 4), torch.float32)
    a_ = abstract_dtensor(d, (Replicate(), Replicate()), (4,), torch.float32)
    bm = abstract_dtensor(d, (Replicate(), Replicate()), (2, 64, 32), torch.bfloat16)
    with pytest.raises(ValueError, match="ssd"):
        ssd_scan.ssd(xp, dt, a_, bm, bm, a_)
    with pytest.raises(ValueError, match="ssd"):  # a plain operand beside a DTensor x
        ssd_scan.ssd(x, dt.to_local(), a_, bm, bm, a_)


@pytest.mark.parametrize("arch,depth,mode", [
    ("granite-8b", {"num_layers": 3}, "train"),
    ("granite-8b", {"num_layers": 3}, "prefill"),
    ("granite-8b", {"num_layers": 3}, "decode"),
    ("mamba2-370m", {"num_layers": 3}, "train"),
    ("seamless-m4t-large-v2", {"encoder_layers": 3, "num_layers": 2}, "decode"),
])
def test_units_times_trips_equal_the_step_on_a_mesh(arch, depth, mode):
    """On a (2, 2) mesh Σ unit x trips is the whole sharded step: flops,
    bytes and collective bytes by kind and by axis."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), **depth)
    shape, d, rules = InputShape("t", 32, 4, mode), _dmesh(2, 2), _rules(mode)
    total = roofline._add(*roofline.units(cfg, shape, None, d, rules).values())
    fn, args = dryrun.step_and_args(cfg, shape, dmesh=d, rules=rules)
    if mode == "train":  # the units count the gradients and the optimizer apart
        whole = roofline._add((roofline._step_work(cfg, shape, None, d, rules), 1),
                              (roofline._opt_work(cfg, d, rules), 1))
    else:
        whole = dryrun.count(fn, *args, dmesh=d)[0].work()
    assert total["flops"] == pytest.approx(whole["flops"], rel=1e-12)
    assert total["bytes"] == pytest.approx(whole["bytes"], rel=1e-12)
    for key in ("coll", "coll_by_axis"):
        assert total[key].keys() == whole[key].keys()
        for name, n in whole[key].items():
            assert total[key][name] == pytest.approx(n, rel=1e-12, abs=1e-6), (key, name)


def test_cli_on_the_production_meshes(tmp_path, capsys):
    """``--multi-pod --rules serve_v2`` and ``--mesh pod``: per-device work,
    collective bytes by kind and axis, a collective term wherever a
    collective ran, the roofline's units summing to the dry-run's step."""
    pair = ["--arch", "qwen2-vl-2b", "--shape", "decode_32k", "--multi-pod", "--rules",
            "serve_v2"]
    dryrun.main(pair + ["--out", str(tmp_path / "dr")])
    roofline.main(pair + ["--out", str(tmp_path / "rl")])
    dryrun.main(["--arch", "mamba2-370m", "--shape", "prefill_32k", "--mesh", "pod",
                 "--out", str(tmp_path / "dr")])
    assert "OK qwen2-vl-2b_decode_32k_h100_pod2_serve_v2" in capsys.readouterr().out
    name = "qwen2-vl-2b_decode_32k_h100_pod2_serve_v2.json"
    with open(tmp_path / "dr" / name) as f:
        dr = json.load(f)
    with open(tmp_path / "rl" / name) as f:
        rl = json.load(f)
    assert dr["mesh"] == {"pod": 2, "data": 16, "model": 16} and dr["chips"] == 512
    assert dr["rules"] == "serve_v2" and dr["max_batch"] is None
    coll = dr["per_device"]["collective_bytes"]
    assert coll["count"] > 0 and coll["total"] == sum(coll[k] for k in dryrun.KINDS)
    assert sum(coll["by_axis"].values()) == coll["total"]
    assert dr["roofline_s"]["collective"] > 0
    assert rl["chips"] == 512 and rl["per_device"]["coll"] == pytest.approx(coll["total"])
    assert rl["roofline_s"]["collective"] == pytest.approx(dr["roofline_s"]["collective"])
    assert rl["useful_flops_ratio"] == pytest.approx(
        rl["model_flops_global"] / (rl["per_device"]["flops"] * 512))
    with open(tmp_path / "dr" / "mamba2-370m_prefill_32k_h100_pod1.json") as f:
        mb = json.load(f)
    assert mb["rules"] == "serve" and mb["per_device"]["kernel_calls"] == {"ssd": 48}
