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

ARCHS = ("granite-8b", "qwen2-vl-2b", "minitron-4b", "mamba2-370m")
B, S, EXTRA = 2, 16, 4
# mamba's prompt spans several chunks of its reduced chunk 16, with a ragged end.
SEQ = {"mamba2-370m": 40}
ATOL = 1e-4   # float32 on both sides; sums taken in another order


def _jax_params(arch):
    cfg = jax_get_config(arch, reduced=True)
    api = jax_build_model(cfg)
    params = api.init(jax.random.key(0), dtype=jnp.float32)
    return api, params, jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        fe = min(cfg.frontend_tokens, s)
        out["frontend_embeds"] = (rng.standard_normal((B, fe, cfg.d_model)) * 0.02).astype(np.float32)
        out["positions3"] = np.broadcast_to(np.arange(s)[None, :, None], (B, s, 3)).astype(np.int32)
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.int64 if v.dtype == np.int32 else torch.float32) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jax_api, jax_params, np_params = _jax_params(arch)
    cfg = get_config(arch, reduced=True)
    api = build_model(cfg)
    params = params_from_numpy(np_params, cfg)
    s = SEQ.get(arch, S)
    max_len = s + EXTRA
    batch = _batch(cfg, 0, s)

    want, jax_caches = jax_api.prefill(jax_params, {k: jnp.asarray(v) for k, v in batch.items()},
                                       max_len)
    got, caches = api.prefill(params, _to_torch(batch), max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, EXTRA)).astype(np.int32)
    for i in range(EXTRA):
        want, jax_caches = jax_api.decode_step(jax_params, jax_caches, jnp.asarray(toks[:, i]),
                                               jnp.int32(s + i), max_len)
        got, caches = api.decode_step(params, caches, torch.from_numpy(toks[:, i]).long(),
                                      s + i, max_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


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
    params = params_from_numpy(tree, cfg)
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


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"))
def test_unported_families_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        build_model(get_config(arch, reduced=True))


def test_ssm_parameters_convert_exactly():
    jax_api = jax_build_model(jax_get_config("mamba2-370m", reduced=True))
    tree = jax.tree_util.tree_map(np.asarray, jax_api.init(jax.random.key(0)))  # bf16
    cfg = get_config("mamba2-370m", reduced=True)
    params = params_from_numpy(tree, cfg)
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
    params = params_from_numpy(tree, cfg)
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
        params_from_numpy({**tree, "tail": {}}, cfg)
