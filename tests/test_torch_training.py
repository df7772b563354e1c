"""The port's training pieces against the JAX package: the optimizer, the
synthetic data, the loss, checkpoints, the launcher, the plain attention's
two softmax forms and the kernels' autograd ``Function``.  Inputs come from
numpy with a seed; both packages compute in float32 unless a test says
otherwise."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.kernels._common import PlainGrad
from repro_torch.kernels.attention import ref
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import build_train_step

OPT_ATOL = 1e-6   # float32 on both sides; XLA may fuse a product into an FMA
SHAPES = [(7, 5), (13,), (3, 4, 6), (1,)]


def _np_tree(rng, scale=1.0):
    return {"a": [(rng.standard_normal(s) * scale).astype(np.float32) for s in SHAPES[:2]],
            "b": {"c": (rng.standard_normal(SHAPES[2]) * scale).astype(np.float32),
                  "d": (rng.standard_normal(SHAPES[3]) * scale).astype(np.float32)}}


def _as(tree, dtype: str):
    """The numpy tree for JAX (bf16 as ml_dtypes) and for the port (torch)."""
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    t_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = jax.tree_util.tree_map(lambda x: jnp.asarray(x.astype(np_dt)), tree)
    t = jax.tree_util.tree_map(lambda x: torch.from_numpy(x.astype(np_dt).astype(np.float32))
                               .to(t_dt), tree)
    return j, t


def _close(jax_tree, torch_tree, atol=OPT_ATOL, rtol=0.0):
    for a, b in zip(jax.tree_util.tree_leaves(jax_tree), tree_leaves(torch_tree), strict=True):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=atol, rtol=rtol)


def test_schedule_matches_jax():
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    steps = np.arange(0, 50, dtype=np.int32)
    want = np.asarray(jax_opt.schedule(jnp.asarray(steps), jax_opt.OptimizerConfig(**cfg)))
    got = opt.schedule(torch.from_numpy(steps), opt.OptimizerConfig(**cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0 and got[5] == np.float32(1e-2) and got[49] == np.float32(1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_jax(dtype):
    j, t = _as(_np_tree(np.random.default_rng(3), 3.0), dtype)
    got = opt.global_norm(t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_opt.global_norm(j)), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, grad_scale):
    """Six steps across warmup and decay, from one random tree: parameters,
    m and v within 1e-6, the norm and the learning rate within 1e-6
    relative; m and v stay float32 and the step an int32 tensor."""
    rng = np.random.default_rng(0)
    jp, tp = _as(_np_tree(rng), dtype)
    jcfg = jax_opt.OptimizerConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    tcfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    js, ts = jax_opt.init_opt_state(jp), opt.init_opt_state(tp)
    update = jax.jit(jax_opt.adamw_update, static_argnums=3)
    for _ in range(6):
        jg, tg = _as(_np_tree(rng, grad_scale), dtype)
        jp, js, jstats = update(jg, js, jp, jcfg)
        tp, ts, tstats = opt.adamw_update(tg, ts, tp, tcfg)
        _close(jp, tp)
        _close(js["m"], ts["m"])
        _close(js["v"], ts["v"])
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
    assert all(x.dtype == torch.float32 for x in tree_leaves(ts["m"]) + tree_leaves(ts["v"]))
    assert all(x.dtype == getattr(torch, dtype) for x in tree_leaves(tp))
    clipped = float(tstats["grad_norm"]) > tcfg.grad_clip
    assert clipped == (grad_scale == 1.0)


def test_clipping_scales_the_gradient_to_the_clip_norm():
    """A gradient of norm above ``grad_clip`` updates as the same gradient
    scaled to norm ``grad_clip`` does; below it, it is not scaled."""
    rng = np.random.default_rng(1)
    base = _np_tree(rng)
    g = _np_tree(rng)
    norm = float(opt.global_norm(_as(g, "float32")[1]))
    cfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=0, grad_clip=1.0)
    results = []
    for factor in (4.0 / norm, 1.0 / norm):  # norm 4 (clipped to 1) and norm 1
        _, p = _as(base, "float32")
        _, grads = _as(jax.tree_util.tree_map(lambda x: (x * factor).astype(np.float32), g),
                       "float32")
        p, _, stats = opt.adamw_update(grads, opt.init_opt_state(p), p, cfg)
        results.append((p, float(stats["grad_norm"])))
    assert results[0][1] == pytest.approx(4.0, rel=1e-5)
    for a, b in zip(tree_leaves(results[0][0]), tree_leaves(results[1][0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_opt_state_lives_beside_each_parameter():
    params = {"w": torch.zeros((3, 2), dtype=torch.bfloat16), "b": [torch.ones(4)]}
    state = opt.init_opt_state(params)
    assert [x.shape for x in tree_leaves(state["m"])] == [(3, 2), (4,)]
    assert all(x.dtype == torch.float32 and not x.any() for x in tree_leaves(state["v"]))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 8, 0), (151_936, 32, 2, 3),
                                                  (97, 17, 3, 11)])
def test_synthetic_tokens_bit_identical_to_reference(vocab, seq, batch, seed):
    want = JaxSyntheticTokens(JaxDataConfig(vocab, seq, batch, seed))
    got = SyntheticTokens(DataConfig(vocab, seq, batch, seed))
    for step in (0, 1, 7):
        a, b = want.batch(step), got.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_cross_entropy_matches_jax_with_masked_labels():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 11, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, (3, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, -1] = -1
    want = jax_layers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), 40)
    got = layers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    none = layers.cross_entropy_loss(torch.from_numpy(logits), torch.full((3, 11), -1))
    assert float(none) == 0.0


# -- the plain attention's softmax -----------------------------------------------

def _qkv(seed, b, s_q, s_kv, h, kv, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                 for shape in ((b, s_q, h, d), (b, s_kv, kv, d), (b, s_kv, kv, d)))


PLAIN_CALLS = {
    "mha": lambda q, k, v: ref.mha(q, k, v, causal=True, window=0, q_offset=4),
    "mha_window": lambda q, k, v: ref.mha(q, k, v, causal=True, window=8),
    "mha_full": lambda q, k, v: ref.mha(q, k, v, causal=False),
    "mha_banded": lambda q, k, v: ref.mha_banded(q, k, v, window=8),
    "decode_gqa": lambda q, k, v: ref.decode_gqa(q[:, 0], k, v, 19, window=8),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(PLAIN_CALLS))
def test_plain_softmax_forms_identical_bit_for_bit(name, dtype):
    """With grad on and an operand that requires grad the softmax makes new
    tensors; with grad off it works in place: the same bits either way, and
    the recorded form differentiates."""
    fn = PLAIN_CALLS[name]
    q, k, v = _qkv(0, 2, 24, 24, 4, 2, 16, dtype)
    with torch.no_grad():
        off = fn(q, k, v)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    on = fn(*leaves)
    assert on.grad_fn is not None
    assert torch.equal(on, off)
    grads = torch.autograd.grad(on.float().square().sum(), leaves)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def test_banded_and_masked_gradients_agree():
    """``mha_banded`` differentiates to ``mha``'s gradients under the same
    window (float32, sums in another order)."""
    q, k, v = _qkv(1, 1, 32, 32, 4, 2, 16)
    grads = []
    for fn in (lambda *a: ref.mha(*a, causal=True, window=8),
               lambda *a: ref.mha_banded(*a, window=8)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves).square().sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


# -- the kernels' autograd Function, with the plain forward injected ---------------

@pytest.mark.parametrize("case", [
    # (b, s_q, s_kv, h, kv, d, causal, window, q_offset)
    (2, 16, 16, 4, 2, 8, True, 0, 0),
    (1, 12, 20, 6, 2, 8, True, 0, 8),
    (2, 9, 13, 4, 4, 8, False, 0, 0),
    (1, 32, 32, 4, 1, 8, True, 8, 0),   # banded on the plain route
    (1, 24, 24, 4, 2, 8, True, 5, 0),
])
def test_plain_grad_flash_matches_native_autograd(case):
    b, s_q, s_kv, h, kv, d, causal, window, off = case
    q, k, v = _qkv(2, b, s_q, s_kv, h, kv, d)
    kw = dict(causal=causal, window=window, q_offset=off)
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal((b, s_q, h, d))
                           .astype(np.float32))
    native = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_plain(*native, **kw), native, cot)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = PlainGrad.apply(ref.flash_plain, ref.flash_plain, kw, *leaves)
    got = torch.autograd.grad(out, leaves, cot)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("use_state", [False, True], ids=["y", "y_and_state"])
def test_plain_grad_ssd_matches_native_autograd(with_h0, use_state):
    """Both outputs take gradients (or only y), every input gets one, h0
    when it is given."""
    rng = np.random.default_rng(4)
    b, s, h, p, n, chunk = 2, 40, 3, 8, 4, 16
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    x, Bm, Cm = f(b, s, h, p), f(b, s, n), f(b, s, n)
    dt = torch.nn.functional.softplus(f(b, s, h))
    A, D = -torch.exp(f(h) * 0.3), f(h)
    h0 = f(b, h, p, n) if with_h0 else None
    gy, gh = f(b, s, h, p), f(b, h, p, n)

    def grads(fn):
        leaves = [None if t is None else t.clone().requires_grad_()
                  for t in (x, dt, A, Bm, Cm, D, h0)]
        y, hf = fn(*leaves)
        outs, cots = ([y, hf], [gy, gh]) if use_state else ([y], [gy])
        return torch.autograd.grad(outs, [t for t in leaves if t is not None], cots)

    plain = lambda *a, chunk=chunk: ssd_ref.ssd_chunked(*a[:6], h0=a[6], chunk=chunk)  # noqa: E731
    want = grads(plain)
    got = grads(lambda *a: PlainGrad.apply(ssd_ref.ssd_chunked, ssd_ref.ssd_chunked,
                                           {"chunk": chunk}, *a))
    assert len(got) == (7 if with_h0 else 6)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# -- checkpoints --------------------------------------------------------------------

def _bf16_state():
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    params = build_model(cfg).init(0, dtype=torch.bfloat16, device="cpu")
    state = opt.init_opt_state(params)
    for x in tree_leaves(state["m"]):
        x.normal_()
    state["step"] = state["step"] + 7
    return params, state


def test_checkpoint_round_trip_is_exact(tmp_path):
    params, state = _bf16_state()
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, {"params": params, "opt": state})
    back = ckpt.restore(path, {"params": params, "opt": state}, device="cpu")
    pairs = list(zip(tree_leaves({"params": params, "opt": state}), tree_leaves(back)))
    assert len(pairs) == len(tree_leaves(params)) * 3 + 1
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["params"]["blocks"], list)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    params, _ = _bf16_state()
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, params)
    params["final_norm"]["scale"] = torch.zeros(3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\['final_norm'\]\['scale'\]"):
        ckpt.restore(path, params, device="cpu")


def test_jax_checkpoint_carried_into_the_port(tmp_path):
    """A checkpoint of the reference's ``ckpt.save`` read with numpy
    (``load_numpy``) and carried through ``params_from_numpy`` and
    ``opt_state_from_numpy``: the port's loss is the reference's."""
    arch = "granite-8b"
    jcfg = jax_get_config(arch, reduced=True)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(1), dtype=jnp.float32)
    jstate = jax_opt.init_opt_state(jparams)
    jstate["step"] = jnp.int32(5)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save(path, {"params": jparams, "opt": jstate})

    tree = ckpt.load_numpy(path)
    cfg = get_config(arch, reduced=True)
    params = params_from_numpy(tree["params"], cfg, device="cpu")
    state = opt_state_from_numpy(tree["opt"], cfg, device="cpu")
    assert int(state["step"]) == 5 and state["step"].dtype == torch.int32
    batch = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 2, 0)).batch(0)
    want, _ = japi.train_loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = build_model(cfg).train_loss(params, {k: torch.from_numpy(v).long()
                                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)


# -- the launcher and convergence -----------------------------------------------------

def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "run.npz")
    launch_train.main(["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2",
                       "--seq", "16", "--log-every", "1", "--ckpt", path])
    out = capsys.readouterr().out.splitlines()
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 3 and all("loss=" in s and "gnorm=" in s and "lr=" in s for s in steps)
    assert out[-1] == f"checkpoint -> {path}"
    tree = ckpt.load_numpy(path)
    assert int(tree["opt"]["step"]) == 3


def test_launch_train_frontend_embeds_as_the_reference_builds_them():
    raw = {"tokens": np.zeros((2, 300), np.int32), "labels": np.zeros((2, 300), np.int32)}
    vision = launch_train.to_batch(raw, get_config("qwen2-vl-2b", reduced=True), "cpu")
    cfg = get_config("qwen2-vl-2b", reduced=True)
    assert vision["frontend_embeds"].shape == (2, min(cfg.frontend_tokens, 300), cfg.d_model)
    encdec = launch_train.to_batch(raw, get_config("seamless-m4t-large-v2", reduced=True), "cpu")
    assert encdec["frontend_embeds"].shape[:2] == (2, 300)
    assert "frontend_embeds" not in launch_train.to_batch(raw, get_config("granite-8b"), "cpu")


def test_training_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--steps", "1"])


class TestTrainingConvergence:
    def test_loss_decreases_on_synthetic_data(self):
        """granite-8b reduced on the Markov-Zipf pipeline, as the reference's
        test trains it: the loss drops by at least 0.3 in 15 steps."""
        cfg = get_config("granite-8b", reduced=True)
        api = build_model(cfg)
        params = api.init(0, dtype=torch.float32, device="cpu")
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                          global_batch=8, seed=0))
        step = build_train_step(api, opt.OptimizerConfig(lr=3e-3, warmup_steps=2,
                                                         total_steps=40))
        state = opt.init_opt_state(params)
        losses = []
        for i in range(15):
            batch = {k: torch.from_numpy(v).long() for k, v in data.batch(i).items()}
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.3, losses


def test_train_step_metrics_stay_on_the_device():
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", reduced=True), num_layers=1)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32, device="cpu")
    batch = {k: torch.from_numpy(v).long()
             for k, v in SyntheticTokens(DataConfig(cfg.vocab_size, 8, 2, 0)).batch(0).items()}
    _, _, m = build_train_step(api, opt.OptimizerConfig())(params, opt.init_opt_state(params),
                                                           batch)
    assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0 and not v.requires_grad
               for v in m.values())
    assert float(m["aux"]) > 0
    np.testing.assert_allclose(float(m["loss"]), float(m["ce"]) + 0.01 * float(m["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("frontend", ["zeros", "random"])
def test_zero_vision_stub_overflows_the_gradient_in_both_packages(frontend):
    """A reference-side fault, copied on purpose: the launcher's vision stub
    feeds zero frontend embeddings (``repro/launch/train.py:51-53``); zero
    rows stay zero through every layer, and each rms norm multiplies their
    gradient by 1/√eps, so at qwen2-vl-2b's 28 layers the gradient is not
    finite in either package (here at the reduced width, float32).  Seeded
    N(0, 0.02²) rows, as the reference's ``concrete_inputs`` makes them,
    train finitely in both."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-vl-2b", reduced=True), num_layers=28)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0), dtype=jnp.float32)
    raw = SyntheticTokens(DataConfig(jcfg.vocab_size, 32, 2, 0)).batch(0)
    fe = (2, min(jcfg.frontend_tokens, 32), jcfg.d_model)
    embeds = (np.zeros(fe, np.float32) if frontend == "zeros" else
              (np.random.default_rng(1).standard_normal(fe) * 0.02).astype(np.float32))
    _, jgrads = jax.value_and_grad(japi.train_loss, has_aux=True)(
        jparams, {**{k: jnp.asarray(v) for k, v in raw.items()},
                  "frontend_embeds": jnp.asarray(embeds)})
    jax_finite = all(bool(jnp.isfinite(g).all()) for g in jax.tree_util.tree_leaves(jgrads))

    cfg = dataclasses.replace(get_config("qwen2-vl-2b", reduced=True), num_layers=28)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    batch = {**{k: torch.from_numpy(v).long() for k, v in raw.items()},
             "frontend_embeds": torch.from_numpy(embeds)}
    _, _, m = build_train_step(build_model(cfg), opt.OptimizerConfig())(
        params, opt.init_opt_state(params), batch)
    assert jax_finite == bool(torch.isfinite(m["grad_norm"])) == (frontend == "random")
    assert bool(torch.isfinite(m["loss"]))
