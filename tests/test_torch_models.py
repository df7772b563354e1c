"""The port's dense transformer against the JAX package: same parameters,
same inputs, prefill and decode logits compared in float32."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model

ARCHS = ("granite-8b", "qwen2-vl-2b")
B, S, EXTRA = 2, 16, 4
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
    max_len = S + EXTRA
    batch = _batch(cfg, 0)

    want, jax_caches = jax_api.prefill(jax_params, {k: jnp.asarray(v) for k, v in batch.items()},
                                       max_len)
    got, caches = api.prefill(params, _to_torch(batch), max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, EXTRA)).astype(np.int32)
    for i in range(EXTRA):
        want, jax_caches = jax_api.decode_step(jax_params, jax_caches, jnp.asarray(toks[:, i]),
                                               jnp.int32(S + i), max_len)
        got, caches = api.decode_step(params, caches, torch.from_numpy(toks[:, i]).long(),
                                      S + i, max_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Port of tests/test_models.py::test_decode_matches_prefill."""
    cfg = get_config(arch, reduced=True)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32, device="cpu")
    max_len = S + EXTRA
    batch = _batch(cfg, 2)
    _, caches = api.prefill(params, _to_torch(batch), max_len)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, EXTRA))
    for i in range(EXTRA):
        last, caches = api.decode_step(params, caches, torch.from_numpy(toks[:, i]), S + i, max_len)
    batch2 = dict(batch)
    batch2["tokens"] = np.concatenate([batch["tokens"], toks.astype(np.int32)], axis=1)
    if "positions3" in batch2:
        batch2["positions3"] = np.broadcast_to(
            np.arange(S + EXTRA)[None, :, None], (B, S + EXTRA, 3)).astype(np.int32)
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


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "mamba2-370m", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"))
def test_unported_families_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        build_model(get_config(arch, reduced=True))
