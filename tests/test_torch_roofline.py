"""Per-unit roofline accounting on meta (repro_torch.launch.roofline) and
the card's table (repro_torch.launch.mesh).

The reference's roofline module sets XLA_FLAGS for 512 host devices when
imported, so its count is taken here by compiling its own unit function,
``repro.models.transformer._superblock_fwd``, directly.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.model import shape_applicable as jax_shape_applicable  # noqa: E402
from repro.models.params import abstract_params as jax_abstract_params  # noqa: E402
from repro.models.model import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels._common import Cost  # noqa: E402
from repro_torch.kernels.attention import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import INPUT_SHAPES, InputShape  # noqa: E402

CARD = mesh.hw(mesh.DEFAULT_SKU)

# One config of each family at reduced width, at a depth of whole
# superblocks beyond the two the units are read from (the hybrid's pattern
# is 3 blocks long: 3 superblocks; the enc-dec config has 3 encoder and 2
# decoder layers, the units come from 1-2 of each).
FAMILIES = {
    "dense": ("granite-8b", {"num_layers": 3}),
    "moe": ("mixtral-8x7b", {"num_layers": 3}),
    "ssm": ("mamba2-370m", {"num_layers": 4}),
    "hybrid": ("recurrentgemma-9b", {"num_layers": 9}),
    "encdec": ("seamless-m4t-large-v2", {"encoder_layers": 3, "num_layers": 2}),
}


@pytest.mark.parametrize("mode", ("train", "prefill", "decode"))
@pytest.mark.parametrize("family", FAMILIES)
def test_units_times_trips_equal_the_whole_step(family, mode):
    """Σ unit × trip count is the dry-run's whole step on meta, flops of each
    dtype and bytes exactly (the optimizer counted once over every leaf)."""
    arch, depth = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **depth)
    shape = InputShape("t", 64, 2, mode)
    units = roofline.units(cfg, shape)
    assert set(units) == ({"enc_block", "dec_block", "head"} if family == "encdec"
                          else {"block", "head"}) | ({"opt"} if mode == "train" else set())
    total = roofline._add(*units.values())
    whole = dryrun.measure(cfg, shape)["work"]
    assert total["flops"] == whole["flops"]
    assert total["bytes"] == whole["bytes"]


def test_hybrid_tail_is_scaled_as_in_the_reference():
    """recurrentgemma-9b's 38 layers are 12 superblocks of 3 and a tail of 2,
    counted as 2/3 of a superblock."""
    cfg = get_config("recurrentgemma-9b")
    assert transformer.super_counts(cfg) == (12, 2)
    res = roofline.run_one("recurrentgemma-9b", "decode_32k", card=CARD)
    assert res["parts"]["block"]["mult"] == pytest.approx(12 + 2 / 3)


# XLA's count of the reference's superblock includes its elementwise work
# (norms, RoPE, the softmax, SiLU) and attention's products over every
# (query, key) pair, the masked ones too; the port counts products only,
# and attention's over the causal band (the kernel's ``cost``).  With the
# masked pairs' products added back, the two agree within the elementwise
# share, below 6% at this width.
ELEMENTWISE_RTOL = 0.06


def test_dense_superblock_products_match_reference_cost_analysis():
    arch, b, s = "granite-8b", 2, 128
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    sb = jax_abstract_params(jax_transformer._superblock_decls(jcfg))
    x = jax.ShapeDtypeStruct((b, s, jcfg.d_model), jnp.bfloat16)

    def fwd(x, sp):
        pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
        y, aux, _ = jax_transformer._superblock_fwd(x, sp, jcfg, pos, False)
        return y, aux

    cost = jax.jit(fwd).lower(x, sb).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xla = float(cost["flops"])
    block = roofline.units(cfg, InputShape("t", s, b, "prefill"))["block"][0]
    assert set(block["flops"]) == {torch.bfloat16}
    port = block["flops"][torch.bfloat16]
    h, d = cfg.num_heads, cfg.head_dim
    masked = 4.0 * b * h * d * (s * s - fa.pairs(s, s, causal=True, window=0, q_offset=0))
    assert port + masked <= xla
    assert port + masked == pytest.approx(xla, rel=ELEMENTWISE_RTOL)


PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_roofline_at_published_widths(arch, shape):
    """Every applicable pair finishes on meta, and exactly the reference's
    inapplicable ones are skipped; the terms, the bottleneck and the parts
    are the reference's keys.  Outside training the total is the dry-run's
    whole step (the hybrid's within its scaled tail)."""
    res = roofline.run_one(arch, shape, card=CARD)
    ok, _ = jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[shape])
    if not ok:
        assert set(res) == {"arch", "shape", "skipped"}
        return
    terms = res["roofline_s"]
    assert set(terms) == {"compute", "memory", "collective"} and terms["collective"] == 0.0
    assert res["bottleneck"] == max(terms, key=terms.get)
    assert terms["compute"] > 0 and terms["memory"] > 0
    assert res["model_flops_global"] > 0 and res["useful_flops_ratio"] > 0
    parts = res["parts"]
    total = sum(p["unit"]["bytes"] * p["mult"] for p in parts.values())
    assert total == pytest.approx(res["per_device"]["bytes"], rel=1e-12)
    if res["mode"] != "train":
        whole = dryrun.measure(get_config(arch), INPUT_SHAPES[shape])["work"]
        rel = 0.02 if arch == "recurrentgemma-9b" else 1e-12
        assert res["per_device"]["bytes"] == pytest.approx(whole["bytes"], rel=rel)
        assert res["per_device"]["flops"] == pytest.approx(sum(whole["flops"].values()), rel=rel)


def test_run_one_takes_an_input_shape_and_a_depth_cut():
    shape = InputShape("decode_4x1024", 1024, 4, "decode")
    res = roofline.run_one("mixtral-8x7b", shape, card=CARD, num_layers=16, pos=322)
    assert (res["shape"], res["batch"], res["seq_len"], res["num_layers"]) == (
        "decode_4x1024", 4, 1024, 16)
    full = roofline.run_one("mixtral-8x7b", shape, card=CARD, num_layers=16)
    assert full["per_device"]["bytes"] > res["per_device"]["bytes"]  # 1024 entries, not 323
    assert "decode_4x1024" not in INPUT_SHAPES


# -- the card's table ----------------------------------------------------------

def test_hw_without_a_card_is_the_data_sheet():
    card = mesh.hw(mesh.DEFAULT_SKU)
    assert card["sku"] == "H100" and not card["from_device"]
    assert card["hbm_bytes"] == 80e9 and card["hbm_bw"] == 3.35e12 and card["sms"] == 132
    assert card["peak_flops"] == {torch.bfloat16: 989e12, torch.float32: 67e12}
    assert card["peak_flops_bf16"] == 989e12
    assert mesh.hw("NVIDIA H100 PCIe")["peak_flops"][torch.bfloat16] == 756e12
    assert mesh.hw("NVIDIA H200")["hbm_bw"] == 4.8e12
    if not torch.cuda.is_available():
        assert mesh.hw() == card
    with pytest.raises(ValueError, match="data-sheet"):
        mesh.hw("NVIDIA A100-SXM4-80GB")


def test_bound_is_the_larger_term():
    card = mesh.hw(mesh.DEFAULT_SKU)
    by_ops = Cost({torch.bfloat16: 989e9, torch.float32: 67e9}, 3.35e6)
    assert mesh.bound_ms(by_ops, card) == (pytest.approx(2.0), "operations")
    by_bytes = Cost({torch.bfloat16: 989e6}, 3.35e9)
    assert mesh.bound_ms(by_bytes, card) == (pytest.approx(1.0), "bytes")
    both = by_bytes.with_backward()
    assert both.flops == {torch.bfloat16: 3 * 989e6} and both.bytes == 2 * 3.35e9
    terms = mesh.roofline_terms({torch.float32: 67e12}, 0.0, card)
    assert terms == {"compute": 1.0, "memory": 0.0, "collective": 0.0}
