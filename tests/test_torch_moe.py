"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's:
the same numpy inputs through both, outputs and aux losses compared in
float32, expert ids compared exactly."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import moe

ATOL = 1e-5  # the reference's own bar between its two forms (tests/test_moe.py:42)
B, S, D, FF = 2, 24, 32, 64
MOE_ARCHS = ("mixtral-8x7b", "granite-moe-1b-a400m")
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(e, k, arch="mixtral-8x7b"):
    over = dict(num_experts=e, experts_per_token=k, d_model=D, d_ff=FF)
    return (dataclasses.replace(jax_get_config(arch, reduced=True), **over),
            dataclasses.replace(get_config(arch, reduced=True), **over))


def _params(e, seed=0, d=D, f=FF):
    rng = np.random.default_rng(seed)
    n = lambda *shape: (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    return {"router": n(d, e), "w_gate": n(e, d, f), "w_up": n(e, d, f), "w_down": n(e, f, d)}


def _x(seed, s=S, d=D):
    return np.random.default_rng(seed).standard_normal((B, s, d)).astype(np.float32)


def _both(fn_name, x, params, jcfg, cfg, **kw):
    want = getattr(jax_moe, fn_name)(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
                                     jcfg, **kw)
    got = getattr(moe, fn_name)(torch.from_numpy(x),
                                {k: torch.from_numpy(v) for k, v in params.items()}, cfg, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("fn_name", ["moe_ffn", "moe_ffn_grouped"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("e", [4, 8, 16])
def test_moe_matches_jax(e, k, fn_name):
    jcfg, cfg = _cfgs(e, k)
    x, params = _x(e * 10 + k), _params(e, seed=k)
    (want, want_aux), (got, got_aux) = _both(fn_name, x, params, jcfg, cfg)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_aux, want_aux, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn_name", ["moe_ffn", "moe_ffn_grouped"])
def test_capacity_drops_the_same_tokens(fn_name):
    """At capacity_factor 0.25 every expert keeps 8 of ~32 routing slots: the
    same slots are dropped, so the same tokens lose every expert (their
    output is exactly 0) and the partly dropped ones match too."""
    jcfg, cfg = _cfgs(4, 2)
    assert moe.capacity(64, cfg, 0.25) == 8
    x, params = _x(5, s=64), _params(4, seed=5)
    (want, _), (got, _) = _both(fn_name, x, params, jcfg, cfg, capacity_factor=0.25)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    dropped = np.all(want == 0.0, axis=-1)
    assert 0 < dropped.sum() < dropped.size
    np.testing.assert_array_equal(np.all(got == 0.0, axis=-1), dropped)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_router_ties_break_to_the_lower_expert(k):
    """x = 0 gives every expert the same probability: jax.lax.top_k puts the
    lower index first, and so must the port."""
    jcfg, cfg = _cfgs(8, k)
    x, params = np.zeros((B, S, D), np.float32), _params(8)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    jw, jids, jaux = jax_moe._router(jnp.asarray(x), jp, jcfg)
    w, ids, aux = moe._router(torch.from_numpy(x), tp, cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids.numpy(), np.broadcast_to(np.arange(k), (B, S, k)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL, rtol=0)
    (want, _), (got, _) = _both("moe_ffn", x, params, jcfg, cfg)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_on_reduced_configs(arch):
    """The router of layer 0 of the reduced model, with the JAX package's own
    initial parameters."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    tree = jax_build_model(jcfg).init(jax.random.key(3), dtype=jnp.float32)
    p = {n: np.array(v[0]) for n, v in tree["blocks"]["b0_attn_moe"]["moe"].items()}
    x = _x(7, s=40, d=cfg.d_model)
    jw, jids, jaux = jax_moe._router(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()},
                                     jcfg)
    w, ids, aux = moe._router(torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()},
                              cfg)
    assert ids.shape == (B, 40, cfg.experts_per_token)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_at_full_width(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for s in (1, 7, 64, 300, 512, 1000, 4096, 8192, 32768):
        for factor in (0.25, 1.0, 1.25, 2.0, 4.0):
            assert moe.capacity(s, cfg, factor) == jax_moe.capacity(s, jcfg, factor), (s, factor)
    if arch == "mixtral-8x7b":
        assert moe.capacity(8192, cfg, cfg.moe_capacity_factor) == 2560
        assert moe.capacity(1, cfg, 2.0) == 8


def test_moe_params_follow_the_reference_decls():
    jcfg, cfg = jax_get_config("mixtral-8x7b"), get_config("mixtral-8x7b")
    want = {n: d.shape for n, d in jax_moe.moe_decls(jcfg).items()}
    assert {n: d.shape for n, d in moe.moe_decls(cfg).items()} == want
    assert want["w_gate"] == (8, 4096, 14336) and want["router"] == (4096, 8)


def test_the_port_never_turns_tf32_on():
    """The router's float32 product is float32 on the card only while TF32 is
    off for matmuls; no module of the port, nor chip_smoke.py, turns it on."""
    on = re.compile(r"allow_tf32\s*=\s*True|set_float32_matmul_precision\(\s*['\"](high|medium)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        assert not on.search(path.read_text()), path
