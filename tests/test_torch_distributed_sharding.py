"""The port's sharding rules (``repro_torch/distributed/sharding.py``)
against the reference's (``repro/distributed/sharding.py``), their DTensor
placements, the production meshes, and the kernels' sharded routes.

* ``RULE_SETS``, ``spec_for_axes`` and ``explain_specs`` equal the
  reference's on every declaration of every architecture's parameters and
  caches (reduced and published widths), under every rule set, on stub
  meshes that have only ``.shape`` (the reference's functions read nothing
  else of a mesh).
* ``placements`` gives local shapes of global / Π axis sizes.
* The GQA slice of replicated K/V for a head shard, at granite-8b's 32/8
  heads on a 16-way axis, read head by head.
* 4 gloo ranks in child processes: decode over a ``kv_seq``-sharded cache
  (each shard at its slot offset, merged by the log-sum-exp), flash
  attention over head- and sequence-sharded queries and the batch-local MoE
  FFN equal the unsharded plain versions.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.params import ParamDecl as RefDecl  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import sharding as core_sharding  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels.attention._common import kv_group_slice  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubMesh:
    """A mesh that is only its ``.shape`` (axis name -> size)."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = {
    "16x16": StubMesh(data=16, model=16),
    "2x16x16": StubMesh(pod=2, data=16, model=16),
    "1": StubMesh(data=1),
    "1x1": StubMesh(data=1, model=1),
}


def _decl_trees(arch: str, reduced: bool):
    """(port param decls, port cache decls, reference param decls,
    reference cache decls) at a decode batch of 32 and 4096 slots."""
    cfg, jcfg = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
    api, japi = M.build_model(cfg), jax_model.build_model(jcfg)
    return (api.param_decls, api.cache_decls(32, 4096), japi.param_decls,
            japi.cache_decls(32, 4096))


def test_rule_sets_equal_the_reference():
    assert list(sharding.RULE_SETS) == list(ref_shd.RULE_SETS)
    for name, rules in sharding.RULE_SETS.items():
        assert rules == ref_shd.RULE_SETS[name], name
    for name in ("TRAIN_RULES", "SERVE_RULES", "SERVE_V2_RULES", "SERVE_EP_RULES",
                 "SERVE_V2_EP_RULES", "TRAIN_EP_RULES", "SERVE_V2_NOSEQ_RULES",
                 "SERVE_V3_RULES", "SERVE_SP_RULES", "TRAIN_SP_RULES"):
        assert getattr(sharding, name) == getattr(ref_shd, name), name


@pytest.mark.parametrize("reduced", (True, False))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_axes_equals_the_reference(arch, reduced):
    """Every declaration of both packages' parameter and cache trees, under
    every rule set, on every stub mesh: the port's spec is the reference's
    ``P`` entry for entry (the port's decls have no stacked layers axis; the
    reference's do, and the port's function is held on those too)."""
    leaves = [d for tree in _decl_trees(arch, reduced) for d in tree_leaves(tree)]
    leaves += [d for d in ref_leaves(_decl_trees(arch, reduced)[2:])]
    seen = set()
    for d in leaves:
        key = (tuple(d.shape), tuple(d.axes))
        if key in seen:
            continue
        seen.add(key)
        for rules in sharding.RULE_SETS.values():
            for stub in MESHES.values():
                want = tuple(ref_shd.spec_for_axes(stub, key[0], key[1], rules))
                assert sharding.spec_for_axes(stub, key[0], key[1], rules) == want, key


def ref_leaves(trees):
    import jax
    return [d for t in trees
            for d in jax.tree_util.tree_leaves(t, is_leaf=lambda x: isinstance(x, RefDecl))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_explain_specs_equals_the_reference(arch):
    """The fallback report of the port's trees is the reference's on the
    same trees (the port's decls carried into the reference's type), line
    for line as a set, on both production meshes under every rule set."""
    params, caches, _, _ = _decl_trees(arch, reduced=False)
    for tree in (params, caches):
        ref_tree = tree_map(lambda d: RefDecl(d.shape, d.axes, d.init, d.scale), tree)
        for rules in sharding.RULE_SETS.values():
            for stub in (MESHES["16x16"], MESHES["2x16x16"]):
                assert (set(sharding.explain_specs(stub, tree, rules))
                        == set(ref_shd.explain_specs(stub, ref_tree, rules)))


@pytest.mark.parametrize("mesh_name", ("16x16", "2x16x16"))
def test_placements_give_global_over_axis_sizes(mesh_name):
    """Every decl of every published arch: Shard(d) on each mesh dim the
    spec maps d to, local dims = global / Π those axes' sizes, pod-major for
    a dim over (pod, data)."""
    stub = MESHES[mesh_name]
    names = list(stub.shape)
    for arch in ARCH_IDS:
        params, caches, _, _ = _decl_trees(arch, reduced=False)
        for d in tree_leaves(params) + tree_leaves(caches):
            for rules in (sharding.TRAIN_RULES, sharding.SERVE_RULES, sharding.SERVE_V2_RULES):
                spec = sharding.spec_for_axes(stub, d.shape, d.axes, rules)
                pl = sharding.placements(stub, spec, len(d.shape))
                want = list(d.shape)
                for dim, entry in enumerate(spec):
                    for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                        assert pl[names.index(axis)] == torch.distributed.tensor.Shard(dim)
                        want[dim] //= stub.shape[axis]
                assert sharding.local_shape(stub, pl, d.shape) == tuple(want)
    assert (sharding.placements(MESHES["2x16x16"], (("pod", "data"),), 2)
            == (torch.distributed.tensor.Shard(0),) * 2 + (torch.distributed.tensor.Replicate(),))
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements(MESHES["2x16x16"], (("data", "pod"),), 1)


def test_batch_shardings_follow_the_reference(monkeypatch):
    """Dim 0 over the batch axes where they divide it, dim 1 over "seq"
    under the sp rules; the reference's ``batch_shardings`` specs (its
    ``NamedSharding`` needs devices: the spec is read before it)."""
    import jax
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda _mesh, spec: spec)
    for stub in MESHES.values():
        for rules in sharding.RULE_SETS.values():
            for shape in ((32, 4096), (1, 4096), (256, 4096, 3), (128,), (32, 7)):
                want = ref_shd.batch_shardings(
                    stub, {"x": jax.ShapeDtypeStruct(shape, "int32")}, rules)
                assert sharding.batch_spec(stub, shape, rules) == tuple(want["x"])


def test_production_meshes_and_links():
    pod1, pod2 = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True)
    assert pod1.shape == {"data": 16, "model": 16} and pod1.size == 256
    assert pod2.shape == {"pod": 2, "data": 16, "model": 16} and pod2.size == 512
    card = mesh.hw(mesh.DEFAULT_SKU)
    assert card["nvlink_bw"] == 450e9 and card["internode_bw"] == 50e9
    assert mesh.hw("NVIDIA H100 PCIe")["nvlink_bw"] == 300e9
    # 16 consecutive ranks span two nodes of 8: every production axis leaves a node.
    for desc in (pod1, pod2):
        for axis in desc.axis_names:
            assert not desc.within_node(axis)
            assert mesh.link_bw(desc, axis, card) == 50e9
    four = mesh.MeshDesc(("data",), (4,))
    assert four.within_node("data") and mesh.link_bw(four, "data", card) == 450e9
    assert mesh.MeshDesc(("data", "model"), (2, 8)).within_node("model")
    assert not mesh.MeshDesc(("data", "model"), (2, 8)).within_node("data")
    terms = mesh.roofline_terms({torch.bfloat16: 0.0}, 0.0, card, {"data": 50e9, "model": 100e9},
                                pod1)
    assert terms["collective"] == pytest.approx(3.0)
    assert mesh.roofline_terms({torch.bfloat16: 0.0}, 0.0, card)["collective"] == 0.0


def test_host_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        mesh.device_mesh(mesh.MeshDesc(("data",), (1,)), "nccl")


def test_kv_group_slice_at_granite_heads():
    """32 query heads over 16 shards, 8 kv heads: each shard's 2 heads read
    exactly the kv head i // 4 of each of its heads."""
    for r in range(16):
        lo, hi = kv_group_slice(32, 8, 16, r)
        assert list(range(lo, hi)) == sorted({h // 4 for h in range(2 * r, 2 * r + 2)})
    for r in range(4):  # whole groups per shard
        lo, hi = kv_group_slice(32, 8, 4, r)
        assert list(range(lo, hi)) == sorted({h // 4 for h in range(8 * r, 8 * r + 8)})
    with pytest.raises(ValueError, match="straddle"):
        kv_group_slice(12, 4, 6, 0)  # 2 local heads over groups of 3
    with pytest.raises(ValueError):
        kv_group_slice(24, 8, 16, 0)  # 24 heads do not divide over 16


_CHILD = """
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.core import sharding as core_sharding
from repro_torch.kernels.attention import decode_attention as da
from repro_torch.kernels.attention import flash_attention as fa
from repro_torch.kernels.attention import ref

core_sharding.init_process_group("cpu")
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
rng = np.random.default_rng(0)
t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
B, H, KV, D, S = 2, 8, 2, 32, 64
q, k, v = t(B, H, D), t(B, S, KV, D), t(B, S, KV, D)
gaps = {{}}
# (cache_len, window): full, partly filled (shards past the length empty),
# rolled under a window as decode_self_attention calls it (cache_len <=
# size, window = size), and a window inside the cache.
for cache_len, window in ((64, 0), (40, 0), (13, 0), (64, 64), (30, 64), (37, 16), (64, 16)):
    want, want_lse = ref.decode_gqa(q, k, v, cache_len, window=window, return_lse=True)
    out, lse = da.decode_attention(
        distribute_tensor(q, mesh, [Replicate()]), distribute_tensor(k, mesh, [Shard(1)]),
        distribute_tensor(v, mesh, [Shard(1)]), cache_len, window=window, return_lse=True)
    assert out.placements == (Replicate(),)
    gaps[f"decode {{cache_len}} {{window}}"] = max(
        (out.to_local() - want).abs().max().item(), (lse.to_local() - want_lse).abs().max().item())
qf, kf, vf = t(B, 16, H, D), t(B, 16, KV, D), t(B, 16, KV, D)
for window in (0, 5):
    want = ref.flash_plain(qf, kf, vf, causal=True, window=window)
    heads = fa.flash_attention(distribute_tensor(qf, mesh, [Shard(2)]),
                               distribute_tensor(kf, mesh, [Replicate()]),
                               distribute_tensor(vf, mesh, [Replicate()]), causal=True, window=window)
    seq = fa.flash_attention(distribute_tensor(qf, mesh, [Shard(1)]),
                             distribute_tensor(kf, mesh, [Shard(1)]),
                             distribute_tensor(vf, mesh, [Shard(1)]), causal=True, window=window)
    gaps[f"flash heads {{window}}"] = (heads.full_tensor() - want).abs().max().item()
    gaps[f"flash seq {{window}}"] = (seq.full_tensor() - want).abs().max().item()
# The MoE FFN batch-local on a (2, 2) ("data", "model") mesh: rows over
# "data", the experts' FFN dim (or, expert-parallel, the experts) over "model".
import dataclasses
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.params import init_params
cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True), num_experts=4)
p = init_params(moe.moe_decls(cfg), 0, dtype=torch.float32, device="cpu")
x = t(4, 16, cfg.d_model)
want, want_aux = moe.moe_ffn(x, p, cfg, capacity_factor=0.5)
mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
for name, dim in (("ffn", None), ("experts", 0)):
    place = {{"router": [Replicate(), Replicate()],
              "w_gate": [Replicate(), Shard(2 if dim is None else 0)],
              "w_up": [Replicate(), Shard(2 if dim is None else 0)],
              "w_down": [Replicate(), Shard(1 if dim is None else 0)]}}
    dp = {{k: distribute_tensor(v, mesh2, place[k]) for k, v in p.items()}}
    out, aux = moe.moe_ffn(distribute_tensor(x, mesh2, [Shard(0), Replicate()]), dp, cfg,
                           capacity_factor=0.5)
    gaps[f"moe {{name}}"] = max((out.full_tensor() - want).abs().max().item(),
                                abs(aux.full_tensor().item() - want_aux.item()))
print(repr(gaps))
dist.destroy_process_group()
"""


def test_sharded_decode_and_flash_on_4_gloo_ranks():
    """Each of 4 ranks: the decode merge over a 4-way slot-sharded cache
    (plain route, float32) equals the unsharded plain decode within 1e-5,
    output and log-sum-exp, full, partly filled and rolled; flash with
    query heads over 4 ranks and replicated K/V (2 local heads inside one
    kv group of 4, the granite case's straddle-free slice) and with a
    4-way sequence shard of q (K/V gathered, each shard at its offset)
    equals the unsharded plain attention; the MoE FFN with its rows over
    "data" and its FFN dim (or its experts) over "model" of a (2, 2) mesh
    equals the unsharded FFN, drops at capacity factor 0.5 and the aux loss
    included."""
    port = core_sharding.free_port()
    procs = []
    for rank in range(4):
        env = core_sharding.host_device_env(4, rank=rank, port=port)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        procs.append(subprocess.Popen([sys.executable, "-c", _CHILD.format()], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
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
        gaps = eval(stdout.strip().splitlines()[-1])  # noqa: S307 (our own repr)
        assert len(gaps) == 13, gaps
        for case, gap in gaps.items():
            assert gap <= 1e-5, (rank, case, gap)
