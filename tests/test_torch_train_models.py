"""The port's training loss and gradients against ``jax.value_and_grad`` of
the JAX package's ``train_loss``, for every reduced architecture; three
train steps from one state in both packages; remat on and off."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro.training.train_step import build_train_step as jax_build_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import build_train_step

ARCHS = ("granite-8b", "qwen2-vl-2b", "minitron-4b", "mamba2-370m", "mixtral-8x7b",
         "granite-moe-1b-a400m", "recurrentgemma-9b", "seamless-m4t-large-v2")
B, S = 2, 16
SEQ = {"mamba2-370m": 40}  # several chunks of the reduced chunk 16, with a ragged end
ENC_FRAMES = 24
LOSS_ATOL = 1e-5
# Each gradient leaf within GRAD_RTOL of its own max|g|: float32 on both
# sides, sums taken in another order (the worst leaf seen: 5.3e-6, mamba).
GRAD_RTOL = 1e-4


def _batch(cfg, seed, s):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    labels[0, 3] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.arch_type == "encdec":
        out["frontend_embeds"] = (rng.standard_normal((B, ENC_FRAMES, cfg.d_model))
                                  * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        fe = min(cfg.frontend_tokens, s)
        out["frontend_embeds"] = (rng.standard_normal((B, fe, cfg.d_model))
                                  * 0.02).astype(np.float32)
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32 else torch.float32)
            for k, v in batch.items()}


def _grads(api, params, batch, impl=None):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    loss, metrics = api.train_loss(tracked, batch, impl=impl)
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    jcfg = jax_get_config(arch, reduced=True)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0), dtype=jnp.float32)
    batch = _batch(jcfg, 0, SEQ.get(arch, S))
    (jloss, jmetrics), jgrads = jax.value_and_grad(japi.train_loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = get_config(arch, reduced=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = params_from_numpy(to_np(jparams), cfg, device="cpu")
    want = tree_leaves(params_from_numpy(to_np(jgrads), cfg, device="cpu"))
    loss, metrics, got = _grads(build_model(cfg), params, _to_torch(batch))

    np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_ATOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]), atol=LOSS_ATOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]), atol=LOSS_ATOL)
    assert (float(metrics["aux"]) > 0) == (cfg.arch_type == "moe")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 0, "a parameter without gradient"
        torch.testing.assert_close(g, w, atol=GRAD_RTOL * scale, rtol=0)


def test_three_train_steps_match_jax():
    """Reduced granite-8b: one JAX step, its state carried into the port
    (``params_from_numpy``, ``opt_state_from_numpy``), then three steps of
    ``build_train_step`` in each package on the same batches.  Loss, norm
    and learning rate per step within 1e-5; parameters within 1e-5 (the
    learning rate 3e-3 times m/√v's rounding; 4e-6 seen), m and v within
    1e-5 of each leaf's max."""
    jcfg = jax_get_config("granite-8b", reduced=True)
    japi = jax_build_model(jcfg)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=40)
    jstep = jax.jit(jax_build_train_step(japi, jax_opt.OptimizerConfig(**ocfg)))
    jparams = japi.init(jax.random.key(0), dtype=jnp.float32)
    jstate = jax_opt.init_opt_state(jparams)
    data = SyntheticTokens(DataConfig(jcfg.vocab_size, 32, 4, 0))
    jparams, jstate, _ = jstep(jparams, jstate, {k: jnp.asarray(v)
                                                 for k, v in data.batch(0).items()})

    cfg = get_config("granite-8b", reduced=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = params_from_numpy(to_np(jparams), cfg, device="cpu")
    state = opt_state_from_numpy(to_np(jstate), cfg, device="cpu")
    step = build_train_step(build_model(cfg), opt.OptimizerConfig(**ocfg))
    for i in range(1, 4):
        raw = data.batch(i)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in raw.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v).long()
                                                for k, v in raw.items()})
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5, rtol=0)
    assert int(state["step"]) == int(jstate["step"]) == 4
    for got, want, rel in ((params, jparams, False), (state["m"], jstate["m"], True),
                           (state["v"], jstate["v"], True)):
        want = tree_leaves(params_from_numpy(to_np(want), cfg, device="cpu"))
        for g, w in zip(tree_leaves(got), want, strict=True):
            atol = 1e-5 * float(w.abs().max()) if rel else 1e-5
            torch.testing.assert_close(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_remat_gives_identical_loss_and_gradients(arch):
    """``cfg.remat`` recomputes each superblock (each enc-dec block) in the
    backward: the attention or ssm layers run twice, the tail once, and the
    loss and every gradient are those without remat, bit for bit."""
    base = get_config(arch, reduced=True)
    if arch == "recurrentgemma-9b":  # two superblocks of 3 and a tail of one rglru block
        base = dataclasses.replace(base, num_layers=7)
    batch = _to_torch(_batch(base, 1, SEQ.get(arch, S)))
    params = build_model(base).init(3, dtype=torch.float32, device="cpu")
    results, calls = [], []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        counted = {"n": 0}
        self_attention, ssm_block = attn.self_attention, ssm.ssm_block

        def count(fn):
            def run(*args, **kwargs):
                counted["n"] += 1
                return fn(*args, **kwargs)
            return run

        attn.self_attention, ssm.ssm_block = count(self_attention), count(ssm_block)
        try:
            results.append(_grads(build_model(cfg), params, batch))
        finally:
            attn.self_attention, ssm.ssm_block = self_attention, ssm_block
        calls.append(counted["n"])
    (l0, m0, g0), (l1, m1, g1) = results
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    if arch == "seamless-m4t-large-v2":
        assert calls[1] == 2 * calls[0]  # every encoder and decoder block
    elif arch == "recurrentgemma-9b":
        assert calls == [2, 4]           # the tail's rglru block runs no attention
    else:
        assert calls[1] == 2 * calls[0] == 2 * base.num_layers
