"""The port's models against the JAX package: same parameters, same inputs,
prefill and decode logits compared in float32."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.model import build_model

ARCHS = ("granite-8b", "qwen2-vl-2b", "minitron-4b", "mamba2-370m", "mixtral-8x7b",
         "granite-moe-1b-a400m", "recurrentgemma-9b", "seamless-m4t-large-v2")
MOE_ARCHS = ("mixtral-8x7b", "granite-moe-1b-a400m")
B, S, EXTRA = 2, 16, 4
# mamba's prompt spans several chunks of its reduced chunk 16, with a ragged end.
SEQ = {"mamba2-370m": 40}
ATOL = 1e-4   # float32 on both sides; sums taken in another order
ENC_FRAMES = 24  # the enc-dec family's frontend frames in these tests


def _jax_params(arch, **overrides):
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True), **overrides)
    api = jax_build_model(cfg)
    params = api.init(jax.random.key(0), dtype=jnp.float32)
    return api, params, jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.arch_type == "encdec":
        out["frontend_embeds"] = (rng.standard_normal((B, ENC_FRAMES, cfg.d_model))
                                  * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        fe = min(cfg.frontend_tokens, s)
        out["frontend_embeds"] = (rng.standard_normal((B, fe, cfg.d_model)) * 0.02).astype(np.float32)
        out["positions3"] = np.broadcast_to(np.arange(s)[None, :, None], (B, s, 3)).astype(np.int32)
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.int64 if v.dtype == np.int32 else torch.float32) for k, v in batch.items()}


def _prefill_and_decode(arch, s, max_len, steps=EXTRA, **overrides):
    """Prefill ``s`` tokens and decode ``steps`` through both packages (the
    reduced config, with ``overrides`` in both), the logits compared at every
    step; returns the port's caches."""
    jax_api, jax_params, np_params = _jax_params(arch, **overrides)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **overrides)
    api = build_model(cfg)
    params = params_from_numpy(np_params, cfg, device="cpu")
    batch = _batch(cfg, 0, s)

    want, jax_caches = jax_api.prefill(jax_params, {k: jnp.asarray(v) for k, v in batch.items()},
                                       max_len)
    got, caches = api.prefill(params, _to_torch(batch), max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    for i in range(steps):
        want, jax_caches = jax_api.decode_step(jax_params, jax_caches, jnp.asarray(toks[:, i]),
                                               jnp.int32(s + i), max_len)
        got, caches = api.decode_step(params, caches, torch.from_numpy(toks[:, i]).long(),
                                      s + i, max_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    return caches


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    s = SEQ.get(arch, S)
    _prefill_and_decode(arch, s, s + EXTRA)


@pytest.mark.parametrize("s", [10, 20, 32], ids=["padded", "rolled", "banded"])
def test_sliding_window_prompts_match_jax(s):
    """Reduced mixtral's window is 16, so its cache holds 16 entries: a prompt
    of 10 is padded into it, one of 20 rolled (token t at t % 16), and one of
    32 also prefills banded (S a multiple of the window, at least two)."""
    from repro_torch.kernels.attention import ref

    cfg = get_config("mixtral-8x7b", reduced=True)
    assert cfg.sliding_window == 16
    assert ref.uses_banded(s, s, causal=True, window=16, q_offset=0) == (s == 32)
    _prefill_and_decode("mixtral-8x7b", s, 64)


def test_decode_past_the_window_matches_jax():
    """A 10-token prompt, then 12 decode steps: positions 16 to 21 overwrite
    the oldest entries of the rolling cache."""
    caches = _prefill_and_decode("mixtral-8x7b", 10, 64, steps=12)
    assert caches["blocks"][0]["k"].shape[1] == 16


@pytest.mark.parametrize("windows", [1, 2, 3])
def test_hybrid_prompts_of_whole_windows_match_jax(windows):
    """Reduced recurrentgemma's local attention has a window of 16
    (``attention_window``; its ``sliding_window`` is 0): prompts of one, two
    and three windows fill and roll its cache of 16, and the longer two
    prefill banded on the plain route."""
    from repro_torch.kernels.attention import ref

    cfg = get_config("recurrentgemma-9b", reduced=True)
    assert (cfg.sliding_window, cfg.attention_window) == (0, 16)
    s = 16 * windows
    assert ref.uses_banded(s, s, causal=True, window=16, q_offset=0) == (windows > 1)
    caches = _prefill_and_decode("recurrentgemma-9b", s, 64)
    assert transformer.layer_kinds(cfg)[2] == "attn_mlp"
    assert caches["blocks"][2]["k"].shape[1] == 16


def test_hybrid_decode_past_the_window_matches_jax():
    """A 10-token prompt, then 12 decode steps past the hybrid's window of 16."""
    caches = _prefill_and_decode("recurrentgemma-9b", 10, 64, steps=12)
    assert caches["blocks"][2]["k"].shape[1] == 16
    assert caches["blocks"][0]["h"].dtype == torch.float32


def test_hybrid_with_recurrentgemmas_head_layout_matches_jax():
    """recurrentgemma-9b's attention layout at a narrow width: 16 query heads
    of dim 256 on one kv head."""
    _prefill_and_decode("recurrentgemma-9b", 20, 40, num_heads=16, num_kv_heads=1,
                        head_dim=256)


def test_hybrid_with_a_tail_matches_jax():
    """Five layers: one (rglru, rglru, attn) superblock and a tail of two
    rglru blocks, converted by ``params_from_numpy`` and run in the
    reference's order."""
    caches = _prefill_and_decode("recurrentgemma-9b", 18, 24, num_layers=5)
    assert [set(c) for c in caches["blocks"]] == [{"conv", "h"}] * 2 + [{"k", "v"}] + \
        [{"conv", "h"}] * 2

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Port of tests/test_models.py::test_decode_matches_prefill."""
    cfg = get_config(arch, reduced=True)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32, device="cpu")
    s = SEQ.get(arch, S)
    max_len = s + EXTRA
    batch = _batch(cfg, 2, s)
    _, caches = api.prefill(params, _to_torch(batch), max_len)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, EXTRA))
    for i in range(EXTRA):
        last, caches = api.decode_step(params, caches, torch.from_numpy(toks[:, i]), s + i, max_len)
    batch2 = dict(batch)
    batch2["tokens"] = np.concatenate([batch["tokens"], toks.astype(np.int32)], axis=1)
    if "positions3" in batch2:
        batch2["positions3"] = np.broadcast_to(
            np.arange(s + EXTRA)[None, :, None], (B, s + EXTRA, 3)).astype(np.int32)
    want, _ = api.prefill(params, _to_torch(batch2), max_len)
    np.testing.assert_allclose(last.numpy(), want.numpy(), atol=ATOL)


def test_bf16_parameters_convert_exactly():
    jax_api = jax_build_model(jax_get_config("granite-8b", reduced=True))
    tree = jax.tree_util.tree_map(np.asarray, jax_api.init(jax.random.key(0)))  # bf16
    cfg = get_config("granite-8b", reduced=True)
    params = params_from_numpy(tree, cfg, device="cpu")
    w = params["blocks"][1]["attn"]["w_q"]
    assert w.dtype == torch.bfloat16 and len(params["blocks"]) == cfg.num_layers
    np.testing.assert_array_equal(
        w.float().numpy(), tree["blocks"]["b0_attn_mlp"]["attn"]["w_q"][1].astype(np.float32))


def test_init_scale_rule_and_device_contract():
    cfg = get_config("granite-8b", reduced=True)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32, device="cpu")
    w = params["blocks"][0]["mlp"]["w_down"]           # fan_in = d_ff
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert torch.equal(params["final_norm"]["scale"], torch.ones(cfg.d_model))
    same = api.init(0, dtype=torch.float32, device="cpu")
    assert torch.equal(same["embed"]["embedding"], params["embed"]["embedding"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init(0)


def test_encdec_parameters_convert_exactly():
    """The enc-dec tree: encoder and decoder blocks stacked on a leading
    layers axis, the encoder's own norm; one dict per layer in the port."""
    jax_api = jax_build_model(jax_get_config("seamless-m4t-large-v2", reduced=True))
    tree = jax.tree_util.tree_map(np.asarray, jax_api.init(jax.random.key(0)))  # bf16
    cfg = get_config("seamless-m4t-large-v2", reduced=True)
    params = params_from_numpy(tree, cfg, device="cpu")
    decls = build_model(cfg).param_decls
    assert set(params) == set(decls) == {"embed", "enc_blocks", "enc_norm", "dec_blocks",
                                         "final_norm"}
    for name, n in (("enc_blocks", cfg.encoder_layers), ("dec_blocks", cfg.num_layers)):
        assert len(params[name]) == len(decls[name]) == n
        for i, block in enumerate(params[name]):
            for path, leaf in _leaves(block):
                want = _at(tree[name], path)[i]
                assert leaf.dtype == torch.bfloat16
                assert tuple(leaf.shape) == _at(decls[name][i], path).shape
                np.testing.assert_array_equal(leaf.float().numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(params["enc_norm"]["scale"].float().numpy(),
                                  tree["enc_norm"]["scale"].astype(np.float32))
    with pytest.raises(ValueError, match="leading axes"):
        params_from_numpy(tree, dataclasses.replace(cfg, num_layers=3), device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_hybrid_and_encdec_build_model_apis():
    """Both families build through ``build_model``; the enc-dec cache holds
    the cross K/V of the reference's 4096 encoder frames."""
    for arch in ("recurrentgemma-9b", "seamless-m4t-large-v2"):
        assert build_model(get_config(arch)).cfg.name == arch
    cfg = get_config("seamless-m4t-large-v2", reduced=True)
    decls = build_model(cfg).cache_decls(2, 48)
    assert len(decls["self"]) == len(decls["cross_k"]) == cfg.num_layers
    assert decls["cross_k"][0].shape == (2, 4096, cfg.num_kv_heads, cfg.head_dim)
    assert decls["self"][0]["k"].shape == (2, 48, cfg.num_kv_heads, cfg.head_dim)


def test_ssm_parameters_convert_exactly():
    jax_api = jax_build_model(jax_get_config("mamba2-370m", reduced=True))
    tree = jax.tree_util.tree_map(np.asarray, jax_api.init(jax.random.key(0)))  # bf16
    cfg = get_config("mamba2-370m", reduced=True)
    params = params_from_numpy(tree, cfg, device="cpu")
    assert len(params["blocks"]) == cfg.num_layers
    assert transformer.layer_kinds(cfg) == ["ssm"] * cfg.num_layers
    for i, block in enumerate(params["blocks"]):
        for name, leaf in block["ssm"].items():
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                leaf.float().numpy(), tree["blocks"]["b0_ssm"]["ssm"][name][i].astype(np.float32))
    decls = build_model(cfg).param_decls
    assert set(params["blocks"][0]) == set(decls["blocks"][0]) == {"ln1", "ssm"}


def test_params_follow_the_reference_execution_order():
    """A pattern of three with a tail of two: superblock 0's sub-blocks in
    pattern order, then superblock 1's, ..., then the tail."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", reduced=True), num_layers=8)
    jcfg = dataclasses.replace(jax_get_config("recurrentgemma-9b", reduced=True), num_layers=8)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.key(1), dtype=jnp.float32))
    assert sorted(tree["tail"]) == ["t0_rglru_mlp", "t1_rglru_mlp"]
    params = params_from_numpy(tree, cfg, device="cpu")
    kinds = transformer.layer_kinds(cfg)
    assert kinds == ["rglru_mlp", "rglru_mlp", "attn_mlp"] * 2 + ["rglru_mlp"] * 2
    want = [tree["blocks"][name]["mlp"]["w_up"][i]
            for i in range(2) for name in ("b0_rglru_mlp", "b1_rglru_mlp", "b2_attn_mlp")]
    want += [tree["tail"][name]["mlp"]["w_up"] for name in ("t0_rglru_mlp", "t1_rglru_mlp")]
    assert len(params["blocks"]) == len(want) == cfg.num_layers
    for block, w in zip(params["blocks"], want):
        np.testing.assert_array_equal(block["mlp"]["w_up"].numpy(), w)
    assert "rec" in params["blocks"][6] and "attn" in params["blocks"][5]
    with pytest.raises(ValueError, match="expected"):
        params_from_numpy({**tree, "tail": {}}, cfg, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_parameters_convert_exactly(arch):
    """The stacked (L, E, D, F) expert leaves and the (L, D, E) router reach
    each layer's dict unchanged (bfloat16 through float32)."""
    jax_api = jax_build_model(jax_get_config(arch, reduced=True))
    tree = jax.tree_util.tree_map(np.asarray, jax_api.init(jax.random.key(0)))  # bf16
    cfg = get_config(arch, reduced=True)
    params = params_from_numpy(tree, cfg, device="cpu")
    assert transformer.layer_kinds(cfg) == ["attn_moe"] * cfg.num_layers
    stacked = tree["blocks"]["b0_attn_moe"]["moe"]
    assert stacked["w_gate"].shape == (cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert stacked["router"].shape == (cfg.num_layers, cfg.d_model, cfg.num_experts)
    decls = build_model(cfg).param_decls
    for i, block in enumerate(params["blocks"]):
        assert set(block) == set(decls["blocks"][i]) == {"ln1", "attn", "ln2", "moe"}
        for name, leaf in block["moe"].items():
            assert leaf.dtype == torch.bfloat16
            assert tuple(leaf.shape) == decls["blocks"][i]["moe"][name].shape
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          stacked[name][i].astype(np.float32))
