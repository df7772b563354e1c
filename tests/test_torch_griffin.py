"""The port's RG-LRU block (``repro_torch/models/griffin.py``) against the JAX
package's: the scan with and without a carried state, the recurrent block
and its one-token decode step, on inputs made with numpy from a seed, in
float32.  The port's scan is log-depth like ``jax.lax.associative_scan`` but
sums in another order, so the two agree to float32 rounding."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import griffin as jax_griffin
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import griffin
from repro_torch.models.convert import _tensor
from repro_torch.models.params import tree_map

ATOL = 1e-5


def _params(seed=0):
    """The reference's rglru parameters (float32, seeded), in both packages,
    with nonzero biases and a spread of Λ so every gate term is exercised."""
    cfg = jax_get_config("recurrentgemma-9b", reduced=True)
    tree = jax_init_params(jax_griffin.rglru_decls(cfg), jax.random.key(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    w = tree["lambda_param"].shape[0]
    for name in ("conv_b", "b_input_gate", "b_rec_gate"):
        tree[name] = (rng.standard_normal(w) * 0.3).astype(np.float32)
    tree["lambda_param"] = rng.uniform(-3.0, 2.0, w).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg, jp, tree_map(lambda x: _tensor(x, "cpu"), tree)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 5, 16, 37, 128])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_none", "h0"])
def test_rglru_scan_matches_jax(s, with_h0):
    cfg, jp, tp = _params()
    rng = np.random.default_rng(s)
    w = cfg.lru_width
    xb = _rand(rng, 2, s, w)
    h0 = _rand(rng, 2, w) if with_h0 else None
    want_seq, want_fin = jax_griffin.rglru_scan(
        jnp.asarray(xb), jp, None if h0 is None else jnp.asarray(h0))
    got_seq, got_fin = griffin.rglru_scan(
        torch.from_numpy(xb), tp, None if h0 is None else torch.from_numpy(h0))
    assert got_fin.dtype == torch.float32 and got_seq.shape == (2, s, w)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(got_fin.numpy(), np.asarray(want_fin), atol=ATOL)


@pytest.mark.parametrize("s", [1, 2, 3, 8, 33])
def test_linear_scan_is_the_recurrence(s):
    """The log-depth rounds give h_t = a_t h_{t-1} + b_t step by step."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (3, s, 7))).double()
    b = torch.from_numpy(rng.standard_normal((3, s, 7)))
    h, want = torch.zeros(3, 7, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(griffin.linear_scan(a, b), torch.stack(want, 1), atol=1e-12,
                               rtol=0)


@pytest.mark.parametrize("s", [3, 20])
def test_recurrent_block_matches_jax(s):
    cfg, jp, tp = _params(1)
    rng = np.random.default_rng(10 + s)
    x = _rand(rng, 2, s, cfg.d_model)
    h0 = _rand(rng, 2, cfg.lru_width)
    want, (want_tail, want_h) = jax_griffin.recurrent_block(jnp.asarray(x), jp, cfg,
                                                           jnp.asarray(h0))
    got, (tail, h) = griffin.recurrent_block(torch.from_numpy(x), tp, get_config(
        "recurrentgemma-9b", reduced=True), torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tail.numpy(), np.asarray(want_tail), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)
    assert tail.shape == (2, cfg.ssm_conv_width - 1, cfg.lru_width)


def test_recurrent_decode_step_matches_jax():
    """Five steps from a random cache; the conv window shifts by one row a
    step and the state stays float32."""
    cfg, jp, tp = _params(2)
    rng = np.random.default_rng(7)
    w = cfg.lru_width
    jc = {"conv": jnp.asarray(_rand(rng, 2, cfg.ssm_conv_width - 1, w)),
          "h": jnp.asarray(_rand(rng, 2, w))}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    tcfg = get_config("recurrentgemma-9b", reduced=True)
    for step in range(5):
        x = _rand(rng, 2, 1, cfg.d_model)
        want, jc = jax_griffin.recurrent_decode_step(jnp.asarray(x), jc, jp, cfg)
        got, tc = griffin.recurrent_decode_step(torch.from_numpy(x), tc, tp, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        for k in ("conv", "h"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=ATOL)
        assert tc["h"].dtype == torch.float32


def test_decode_steps_continue_the_scan():
    """A prefill's (conv tail, state) carried through decode steps gives the
    outputs of one longer prefill, as in the reference."""
    cfg, _, tp = _params(3)
    tcfg = get_config("recurrentgemma-9b", reduced=True)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, 2, 12, cfg.d_model))
    want, _ = griffin.recurrent_block(x, tp, tcfg)
    _, (tail, h) = griffin.recurrent_block(x[:, :8], tp, tcfg)
    cache = {"conv": tail, "h": h}
    for t in range(8, 12):
        got, cache = griffin.recurrent_decode_step(x[:, t:t + 1], cache, tp, tcfg)
        torch.testing.assert_close(got[:, 0], want[:, t], atol=ATOL, rtol=0)


def test_rounding_points_follow_the_input_dtype():
    """bf16 in: the conv and h_seq come back in bf16, the final state and
    the decode state in float32, as the reference keeps them."""
    cfg, _, tp = _params(4)
    tcfg = get_config("recurrentgemma-9b", reduced=True)
    tp16 = tree_map(lambda x: x.to(torch.bfloat16), tp)
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator().manual_seed(0))
    out, (tail, h) = griffin.recurrent_block(x.to(torch.bfloat16), tp16, tcfg)
    assert out.dtype == tail.dtype == torch.bfloat16 and h.dtype == torch.float32
    out, cache = griffin.recurrent_decode_step(x[:, :1].to(torch.bfloat16),
                                               {"conv": tail, "h": h}, tp16, tcfg)
    assert out.dtype == torch.bfloat16 and cache["h"].dtype == torch.float32
