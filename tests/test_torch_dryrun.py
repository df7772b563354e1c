"""The dry-run on torch's meta device (repro_torch.launch.dryrun), its
inputs (repro_torch.models.model) and the kernels' meta route, against the
JAX package where it has a counterpart.

The reference's dry-run and roofline set XLA_FLAGS for 512 host devices when
imported, so they are not imported here: the reference's side is its
``models/model.py``, ``models/params.py`` and ``configs``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.params import count_params as jax_count_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels._common import counting_costs  # noqa: E402
from repro_torch.kernels.attention import decode_attention as da  # noqa: E402
from repro_torch.kernels.attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import count_params, tree_leaves  # noqa: E402
from repro_torch.training.optimizer import abstract_opt_state, init_opt_state  # noqa: E402

SHAPES = tuple(M.INPUT_SHAPES)
PAIRS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def test_same_archs_and_shapes():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    assert SHAPES == tuple(jax_model.INPUT_SHAPES)
    for name, shape in M.INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(jax_model.INPUT_SHAPES[name])


# -- inputs ------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_reference(arch, shape):
    """Every input's shape and dtype, and the applicability rule, are the
    reference's; the port's specs are meta tensors."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert M.shape_applicable(cfg, M.INPUT_SHAPES[shape]) == jax_model.shape_applicable(
        jcfg, jax_model.INPUT_SHAPES[shape])
    got = M.input_specs(cfg, M.INPUT_SHAPES[shape])
    want = jax_model.input_specs(jcfg, jax_model.INPUT_SHAPES[shape])
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
    if M.INPUT_SHAPES[shape].mode == "decode":
        tok, pos = M.decode_token_specs(M.INPUT_SHAPES[shape])
        jtok, jpos = jax_model.decode_token_specs(jax_model.INPUT_SHAPES[shape])
        assert tuple(tok.shape) == tuple(jtok.shape) and tok.dtype == torch.int32
        assert jpos.shape == () and pos == M.INPUT_SHAPES[shape].seq_len - 1


@pytest.mark.parametrize("mode", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_concrete_inputs_bit_for_bit(arch, mode):
    """The same seed gives the reference's batch bit for bit."""
    seed = 11
    shape = M.InputShape("t", 48, 3, mode)
    got = M.concrete_inputs(get_config(arch, reduced=True), shape, seed, device="cpu")
    want = jax_model.concrete_inputs(jax_get_config(arch, reduced=True),
                                     jax_model.InputShape("t", 48, 3, mode),
                                     jax.random.key(seed))
    assert list(got) == list(want)
    for k, t in got.items():
        w = want[k]
        if w.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(w.astype(jnp.float32)))
        else:
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


# -- abstract parameters and optimizer state ------------------------------------

# cfg.param_count is a closed form; the hybrid's leaves out the RG-LRU's two
# W x W gate matrices (9.57B of recurrentgemma-9b's 10.44B), the others only
# norm scales and biases.
PARAM_COUNT_RTOL = {"recurrentgemma-9b": 0.1}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_opt_state_bytes(arch):
    cfg = get_config(arch)
    api = M.build_model(cfg)
    params = api.abstract()
    leaves = tree_leaves(params)
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16 for p in leaves)
    n = sum(p.numel() for p in leaves)
    assert n == count_params(api.param_decls)
    assert count_params(api.param_decls) == jax_count_params(
        jax_model.build_model(jax_get_config(arch)).param_decls)
    assert n == pytest.approx(cfg.param_count, rel=PARAM_COUNT_RTOL.get(arch, 3e-4))
    assert sum(p.numel() * p.element_size() for p in leaves) == 2 * n
    state = abstract_opt_state(params)
    for key in ("m", "v"):
        assert all(t.device.type == "meta" and t.dtype == torch.float32
                   for t in tree_leaves(state[key]))
        assert sum(t.numel() for t in tree_leaves(state[key])) == n
    assert state["step"].shape == () and state["step"].dtype == torch.int32


def test_init_on_meta_is_abstract():
    """``api.init(device="meta")`` draws nothing: it is ``abstract``'s tree."""
    api = M.build_model(get_config("granite-8b", reduced=True))
    got, want = api.init(0, device="meta"), api.abstract()
    assert [(t.shape, t.dtype, t.device.type) for t in tree_leaves(got)] == [
        (t.shape, t.dtype, t.device.type) for t in tree_leaves(want)]
    state = init_opt_state(got)
    assert state["m"]["final_norm"]["scale"].device.type == "meta"


# -- the kernels' meta route ------------------------------------------------

class _Costs:
    def __init__(self):
        self.calls = []

    def add_kernel(self, name, cost):
        self.calls.append((name, cost))


FLASH_CASES = [
    # (b, s_q, s_kv, h, kv, d, causal, window, q_offset)
    (2, 64, 64, 4, 2, 64, True, 0, 0),
    (1, 96, 96, 8, 8, 128, True, 32, 0),
    (2, 16, 80, 4, 1, 32, False, 0, 0),
    (1, 8, 40, 4, 2, 64, True, 0, 32),
    (1, 1, 64, 16, 16, 64, False, 0, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_meta_route(case, dtype):
    b, s_q, s_kv, h, kv, d, causal, window, off = case
    kw = dict(causal=causal, window=window, q_offset=off)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(sh, generator=gen).to(dtype)
               for sh in ((b, s_q, h, d), (b, s_kv, kv, d), (b, s_kv, kv, d)))
    want = attn_ref.flash_plain(q, k, v, **kw)
    sink, before = _Costs(), fa.launches
    with counting_costs(sink):
        got = fa.flash_attention(*(x.to("meta") for x in (q, k, v)), **kw)
        plain = fa.flash_attention(q, k, v, **kw)  # a CPU tensor: the plain version
    assert fa.launches == before
    assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(plain, want)
    pairs = int(attn_ref.attention_mask(s_q, s_kv, device="cpu", **kw).sum())
    assert fa.pairs(s_q, s_kv, **kw) == pairs
    cost = fa.cost(b, s_q, s_kv, h, kv, d, dtype=dtype, **kw)
    assert cost.flops == {dtype: 4.0 * b * h * d * pairs}
    assert cost.bytes == (2 * q.numel() + 2 * k.numel()) * q.element_size()
    assert sink.calls == [("flash_attention", cost)]


@pytest.mark.parametrize("case", [
    # (b, h, kv, d, s_max, cache_len, window)
    (2, 8, 2, 64, 96, 40, 0),
    (3, 16, 1, 128, 64, 64, 32),
    (1, 4, 4, 32, 80, 100, 48),
])
def test_decode_meta_route(case):
    b, h, kv, d, s_max, clen, window = case
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((b, h, d), generator=gen).bfloat16()
    kc, vc = (torch.randn((b, s_max, kv, d), generator=gen).bfloat16() for _ in range(2))
    want = attn_ref.decode_gqa(q, kc, vc, clen, window=window)
    sink, before = _Costs(), da.launches
    with counting_costs(sink):
        got = da.decode_attention(q.to("meta"), kc.to("meta"), vc.to("meta"), clen, window=window)
        plain = da.decode_attention(q, kc, vc, clen, window=window)
    assert da.launches == before
    assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(plain, want)
    pos = torch.arange(s_max)
    valid = (pos < clen) & ((pos >= clen - window) if window else True)
    n = int(valid.sum())
    cost = da.cost(b, h, kv, d, s_max, clen, window=window, dtype=torch.bfloat16)
    assert cost.flops == {torch.bfloat16: 4.0 * b * h * d * n}
    assert cost.bytes == (2 * b * n * kv * d + 2 * b * h * d) * 2 + 4 * b
    assert sink.calls == [("decode_attention", cost)]


def _ssd_inputs(b, s, h, p, n, dtype, h0):
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn((b, s, h, p), generator=gen) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen))
    A = -torch.exp(torch.randn((h,), generator=gen) * 0.3)
    Bm, Cm = (torch.randn((b, s, n), generator=gen).to(dtype) for _ in range(2))
    D = torch.ones((h,))
    return x, dt, A, Bm, Cm, D, (torch.randn((b, h, p, n), generator=gen) if h0 else None)


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_ssd_meta_route(dtype, with_h0):
    b, s, h, p, n, chunk = 2, 100, 4, 32, 16, 32
    inputs = _ssd_inputs(b, s, h, p, n, dtype, with_h0)
    wy, wh = ssd_ref.ssd_chunked(*inputs[:6], h0=inputs[6], chunk=chunk)
    meta = [None if t is None else t.to("meta") for t in inputs]
    sink, before = _Costs(), ssd_scan.launches
    with counting_costs(sink):
        gy, gh = ssd_scan.ssd(*meta[:6], h0=meta[6], chunk=chunk)
        py, ph = ssd_scan.ssd(*inputs[:6], h0=inputs[6], chunk=chunk)
    assert ssd_scan.launches == before
    for got, want in ((gy, wy), (gh, wh)):
        assert got.device.type == "meta" and got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(py, wy) and torch.equal(ph, wh)
    cost = ssd_scan.cost(b, s, h, p, n, chunk=chunk, h0=with_h0, dtype=dtype)
    chunks = -(-s // chunk)
    assert cost.flops == {dtype: float(2 * chunk * chunk * n * b * chunks
                                       + 2 * chunk * (chunk * p + 2 * n * p) * b * h * chunks)}
    elem = inputs[0].element_size()
    assert cost.bytes == (2 * inputs[0].numel() * elem + inputs[1].numel() * 4
                          + 2 * inputs[3].numel() * elem
                          + (inputs[6].numel() * 4 if with_h0 else 0) + wh.numel() * 4)
    assert sink.calls == [("ssd", cost)]


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_ssd_meta_route_backward_is_the_kernel(dtype, with_h0):
    """Under autograd the SSD call on meta counts the forward's ``cost``
    and one ``ssd_scan_bwd`` call of ``cost_backward`` (it was the plain
    version's eager ops until the backward kernel existed), launches
    nothing, and gives every input a gradient of its shape and dtype."""
    b, s, h, p, n, chunk = 2, 100, 4, 32, 16, 32
    inputs = [t for t in _ssd_inputs(b, s, h, p, n, dtype, with_h0) if t is not None]
    meta = [t.to("meta").requires_grad_() for t in inputs]
    counter = dryrun.WorkCounter()
    before = (ssd_scan.launches, ssd_scan.bwd_launches)
    with counting_costs(counter), counter:
        y, _ = ssd_scan.ssd(*meta[:6], h0=meta[6] if with_h0 else None, chunk=chunk)
        grads = torch.autograd.grad(y, meta, torch.empty_like(y))
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == before
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in meta]
    assert counter.kernels == {"ssd": 1, "ssd_scan_bwd": 1}
    fwd = ssd_scan.cost(b, s, h, p, n, chunk=chunk, h0=with_h0, dtype=dtype)
    bwd = ssd_scan.cost_backward(b, s, h, p, n, chunk=chunk, h0=with_h0, dtype=dtype)
    assert counter.flops == {dtype: fwd.flops[dtype] + bwd.flops[dtype]}
    assert counter.bytes >= fwd.bytes + bwd.bytes


def test_meta_route_checks_operands_as_a_launch():
    """What the kernel does not take is refused on meta as on the card."""
    q = torch.empty((1, 8, 4, 80), dtype=torch.bfloat16, device="meta")  # head dim 80
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.empty((1, 8, 4, 64), dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)
    q = torch.empty((2, 40, 64), dtype=torch.bfloat16, device="meta")  # group 20 > 16
    kc = torch.empty((2, 32, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="group"):
        da.decode_attention(q, kc, kc, 8)


def test_meta_route_backward_is_the_plain_versions():
    """Under autograd the meta route's backward is the backward kernel's
    meta route (it was the plain version's until the kernel existed): every
    input gets a gradient of its shape, and the counter sees exactly one
    ``flash_attention_bwd`` call of ``cost_backward`` beside the forward's
    ``cost`` (with the log-sum-exp it writes for the backward), and no
    product of a plain backward."""
    q = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, device="meta", requires_grad=True)
    k = torch.empty((2, 64, 2, 32), dtype=torch.bfloat16, device="meta", requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    counter = dryrun.WorkCounter()
    with counting_costs(counter), counter:
        out = fa.flash_attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert counter.kernels == {"flash_attention": 1, "flash_attention_bwd": 1}
    kw = dict(causal=True, window=0, q_offset=0, dtype=torch.bfloat16)
    fwd = fa.cost(2, 64, 64, 4, 2, 32, lse=True, **kw)
    bwd = fa.cost_backward(2, 64, 64, 4, 2, 32, **kw)
    assert counter.flops == {torch.bfloat16: fwd.flops[torch.bfloat16] + bwd.flops[torch.bfloat16]}
    assert counter.bytes >= fwd.bytes + bwd.bytes


# -- the counter ---------------------------------------------------------------

def test_counter_counts_products_bytes_and_peak():
    a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    b = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")

    def fn(a, b):
        c = a @ b                 # mm: 2·64·32·16 products, reads a and b, writes c
        v = c.view(16, 64)        # a view moves nothing
        c.mul_(2.0)               # in place: c once (and the 0-dim scalar is on the host)
        d = c.float()             # a copy: reads c, writes d
        del v, c
        return d.sum()

    counter, out, arg_bytes = dryrun.count(fn, a, b)
    assert counter.flops == {torch.bfloat16: 2.0 * 64 * 32 * 16}
    assert arg_bytes == (64 * 32 + 32 * 16) * 2
    c, d = 64 * 16 * 2, 64 * 16 * 4
    assert counter.bytes == (arg_bytes + c) + c + (c + d) + (d + 4)
    assert counter.peak == arg_bytes + c + d   # c is freed before the sum is made


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_whole_step_at_reduced_width(arch):
    """Every family's train, prefill and decode steps run on meta through
    the kernels' meta route, at reduced widths; the attention and SSD
    kernels are called once per layer (twice in training: remat)."""
    cfg = get_config(arch, reduced=True)
    for mode in ("train", "prefill", "decode"):
        m = dryrun.measure(cfg, M.InputShape("t", 64, 2, mode))
        assert m["peak_bytes"] >= m["argument_bytes"] > 0
        assert sum(m["work"]["flops"].values()) > 0 and m["work"]["bytes"] > 0
        calls = sum(m["kernels"].values())
        assert calls > 0 or (cfg.arch_type == "ssm" and mode == "decode")


def test_largest_batch_is_affine():
    assert dryrun.largest_batch(8, 180, 4, 100, 1000) == 49   # 20 + 20·b <= 1000
    assert dryrun.largest_batch(8, 180, 4, 100, 10) == 0
    assert dryrun.second_batch(256) == 128 and dryrun.second_batch(1) == 2


# Published widths: every decode and prefill pair (and the skipped ones),
# and one training step; the CLI runs all 44 pairs (README).
CHEAP = [(a, s) for a, s in PAIRS if s != "train_4k"] + [("qwen2-vl-2b", "train_4k")]


@pytest.mark.parametrize("arch,shape", CHEAP)
def test_dryrun_at_published_widths(arch, shape):
    card = mesh.hw(mesh.DEFAULT_SKU)
    res = dryrun.run_one(arch, shape, card=card)
    ok, _ = jax_model.shape_applicable(jax_get_config(arch), jax_model.INPUT_SHAPES[shape])
    if not ok:
        assert "skipped" in res
        return
    d = res["per_device"]
    assert res["fits"] == (d["peak_bytes"] <= card["hbm_bytes"])
    assert d["peak_bytes"] >= d["argument_bytes"]
    assert res["max_batch"] >= 0 and res["fits"] == (res["max_batch"] >= res["batch"])
    assert res["bottleneck"] in ("compute", "memory")
    kernel = "decode_attention" if res["mode"] == "decode" else (
        "ssd" if arch == "mamba2-370m" else "flash_attention")
    cfg = get_config(arch)
    if not (arch == "mamba2-370m" and res["mode"] == "decode"):
        calls = d["kernel_calls"][kernel]
        per_layer = 2 if res["mode"] == "train" else 1
        if cfg.arch_type == "hybrid":
            n_attn = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "attn"
                         for i in range(cfg.num_layers))
            assert calls == per_layer * n_attn
        elif cfg.arch_type != "encdec":
            assert calls == per_layer * cfg.num_layers
