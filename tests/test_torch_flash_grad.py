"""Flash attention's backward: the port's plain backward from the saved
log-sum-exp (``ref.flash_bwd_plain``) and its forward's log-sum-exp
(``ref.flash_plain_lse``) against the JAX package's plain route under
``jax.vjp`` and ``jax.nn.logsumexp``, and ``FlashAttentionFn`` (the
autograd Function the kernels sit in on the card) with the plain versions
injected as its kernels, against native autograd."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels.attention import ops as jax_ops
from repro.kernels.attention import ref as jax_ref
from repro_torch.kernels.attention import flash_attention as fa
from repro_torch.kernels.attention import ref

RTOL = 1e-5  # float32 on both sides: each gradient's largest gap over its max|g|

# chip_smoke.py's FLASH_CASES (q_offset = S_kv - S_q when causal), then
# recurrentgemma-9b's layout (16 heads of 256 on 1) under a window (banded
# on both plain routes) and cross attention with S_q > S_kv.
CASES = [
    # (b, s_q, s_kv, h, kv, d, causal, window)
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 200, 200, 8, 8, 128, True, 0),
    (2, 64, 256, 4, 1, 32, False, 0),
    (1, 256, 256, 4, 2, 64, True, 64),
    (2, 96, 96, 6, 3, 64, True, 0),
    (1, 128, 512, 4, 4, 128, True, 0),
    (1, 256, 256, 16, 1, 256, True, 64),
    (1, 80, 48, 6, 2, 64, False, 0),
]
IDS = ["-".join(map(str, c)) for c in CASES]


def _inputs(case, seed=0):
    """float32 numpy q, k, v and the output's cotangent, and the masks."""
    b, s_q, s_kv, h, kv, d, causal, window = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s_q, h, d), (b, s_kv, kv, d), (b, s_kv, kv, d), (b, s_q, h, d))]
    return arrays, dict(causal=causal, window=window, q_offset=s_kv - s_q if causal else 0)


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _plain_backward(arrays, kw):
    q, k, v, cot = (torch.from_numpy(a) for a in arrays)
    out, lse = ref.flash_plain_lse(q, k, v, **kw)
    return ref.flash_bwd_plain(q, k, v, out, lse, cot, **kw)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_plain_matches_jax_vjp(case):
    """The JAX package's plain route (``mha_banded`` where its dispatch
    picks it) differentiated by ``jax.vjp``."""
    arrays, kw = _inputs(case)
    q, k, v, cot = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jax_ops.flash_attention(q, k, v, impl="ref", **kw), q, k, v)
    want = vjp(cot)
    got = _plain_backward(arrays, kw)
    gaps = [_gap(g.numpy(), w) for g, w in zip(got, want)]
    assert max(gaps) <= RTOL, gaps


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_plain_matches_native_autograd(case):
    arrays, kw = _inputs(case, seed=1)
    q, k, v, cot = (torch.from_numpy(a) for a in arrays)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_plain(*leaves, **kw), leaves, cot)
    got = _plain_backward(arrays, kw)
    assert all(g.dtype == torch.float32 and g.shape == x.shape for g, x in zip(got, leaves))
    gaps = [_gap(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    assert max(gaps) <= RTOL, gaps


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_lse_matches_jax_logsumexp(case):
    """``flash_plain_lse``: the plain output and the log-sum-exp of each
    row's masked scaled logits, (B, H, S_q)."""
    b, s_q, s_kv, h, kv, d = case[:6]
    arrays, kw = _inputs(case, seed=2)
    q, k, v, _ = arrays

    @jax.jit
    def jax_lse(q, k):
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, jax_ref._expand_kv(k, h)) * ref.softmax_scale(d)
        mask = jax_ref.attention_mask(s_q, s_kv, **kw)
        return jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1)

    want = jax_lse(jnp.asarray(q), jnp.asarray(k))
    out, lse = ref.flash_plain_lse(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s_q)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    plain = ref.flash_plain(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_function_with_plain_kernels_matches_native_autograd(case):
    """``FlashAttentionFn`` with ``ref.flash_plain_lse`` as its forward and
    ``ref.flash_bwd_plain`` as its backward: the output bit for bit, the
    gradients within RTOL of native autograd's, every input given one."""
    arrays, kw = _inputs(case, seed=3)
    q, k, v, cot = (torch.from_numpy(a) for a in arrays)
    native = [x.clone().requires_grad_() for x in (q, k, v)]
    want_out = ref.flash_plain(*native, **kw)
    want = torch.autograd.grad(want_out, native, cot)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(ref.flash_plain_lse, ref.flash_bwd_plain, kw, *leaves)
    assert torch.equal(out.detach(), want_out.detach())
    got = torch.autograd.grad(out, leaves, cot)
    gaps = [_gap(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    assert max(gaps) <= RTOL, gaps


def test_flash_function_backward_gets_a_contiguous_cotangent():
    """A cotangent that is a strided view (here the transpose of a
    contiguous tensor) reaches the backward contiguous, as the kernel reads
    it with 16-byte loads."""
    arrays, kw = _inputs(CASES[0], seed=4)
    q, k, v, _ = (torch.from_numpy(a) for a in arrays)
    seen = []

    def bwd(*args, **kwargs):
        seen.append(args[5].is_contiguous())
        return ref.flash_bwd_plain(*args, **kwargs)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(ref.flash_plain_lse, bwd, kw, *leaves)
    (out.transpose(1, 2) * torch.ones(out.transpose(1, 2).shape)).sum().backward()
    assert seen == [True]


def test_cost_backward_is_twice_the_forwards_products():
    kw = dict(causal=True, window=64, q_offset=0)
    fwd = fa.cost(2, 256, 256, 12, 2, 128, dtype=torch.bfloat16, **kw)
    bwd = fa.cost_backward(2, 256, 256, 12, 2, 128, dtype=torch.bfloat16, **kw)
    assert bwd.flops == {torch.bfloat16: 2 * fwd.flops[torch.bfloat16]}
    q, kv, lse = 2 * 256 * 12 * 128 * 2, 2 * 256 * 2 * 128 * 2, 2 * 12 * 256 * 4
    assert bwd.bytes == 4 * q + 4 * kv + lse   # q, out, dout, dq; k, v, dk, dv
    assert fa.cost(2, 256, 256, 12, 2, 128, dtype=torch.bfloat16, lse=True, **kw).bytes == (
        fwd.bytes + lse)


# -- the backward kernel's launch plan (``fa.bwd_plan``) ------------------------

PLAN_MASKS = {"causal": dict(causal=True, window=0), "window": dict(causal=True, window=96),
              "full": dict(causal=False, window=0)}
# G = H / KV of 1 (seamless), 3 (minitron-4b), 6 (qwen2-vl-2b), 16
# (recurrentgemma-9b); S_q, S_kv and q_offset not multiples of the tile.
PLAN_SHAPES = [(2, 200, 200, 4, 4, 64, 0), (1, 300, 300, 24, 8, 128, 0),
               (2, 130, 257, 12, 2, 128, 127), (1, 333, 333, 16, 1, 256, 0)]
PLAN_IDS = [f"G{h // kv}" for _, _, _, h, kv, _, _ in PLAN_SHAPES]


def _plan(shape, mask, dtype=torch.bfloat16):
    b, s_q, s_kv, h, kv, d, off = shape
    return fa.bwd_plan(b, s_q, s_kv, h, kv, d, q_offset=off, dtype=dtype, **PLAN_MASKS[mask])


def _visible(plan) -> np.ndarray:
    """(S_q, S_kv): the pairs ``ref.attention_mask`` lets through."""
    q = np.arange(plan.s_q)[:, None] + plan.q_offset
    k = np.arange(plan.s_kv)[None, :]
    ok = np.ones((plan.s_q, plan.s_kv), bool)
    if plan.causal:
        ok &= k <= q
    if plan.window > 0:
        ok &= k > q - plan.window
    return ok


@pytest.mark.parametrize("mask", PLAN_MASKS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_bwd_plan_covers_every_tile_head_and_batch_once(shape, mask):
    """The bf16 route's dK/dV pass has one block per (key tile, query head,
    batch row) and the dQ pass one per (query tile, head, batch row), each
    exactly once, a tile 128 rows (64 at D = 256), and the grids are what
    the kernel's host side checks."""
    plan = _plan(shape, mask)
    b, s_q, s_kv, h, kv, d, _ = shape
    own = 64 if d == 256 else 128
    assert (plan.own_tile, plan.stream_tile) == (own, 64)
    n_k, n_q = -(-s_kv // own), -(-s_q // own)
    for dq, n_own in ((False, n_k), (True, n_q)):
        blocks = fa.bwd_blocks(plan, dq)
        assert len(blocks) == n_own * h * b
        seen = {tuple(r) for r in blocks[:, :3]}
        assert seen == {(t, hh, bb) for t in range(n_own) for hh in range(h) for bb in range(b)}
    assert plan.dkdv_blocks == n_k * h * b and plan.dq_blocks == n_q * h * b
    assert plan.grids[0] == (-(-b * h * s_q // 8), 1, 1)


@pytest.mark.parametrize("mask", PLAN_MASKS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_bwd_plan_runs_the_blocks_with_the_most_work_first(shape, mask):
    """Under the causal mask the first key tiles (dK/dV) and the last query
    tiles (dQ) go first, so that without a window each pass's streamed
    tiles per block never rise in launch order (a window's band gives the
    tiles in the middle one tile more than those at the ends); a group's
    heads of one tile are neighbours."""
    plan = _plan(shape, mask)
    n_k, n_q = -(-plan.s_kv // plan.own_tile), -(-plan.s_q // plan.own_tile)
    for dq, n_own in ((False, n_k), (True, n_q)):
        blocks = fa.bwd_blocks(plan, dq)
        if plan.window == 0:
            assert (np.diff(blocks[:, 3]) <= 0).all()
        tiles = blocks[::plan.h * plan.b, 0]
        assert list(tiles) == (list(range(n_own)) if plan.causal != dq
                               else list(range(n_own))[::-1])
        h = plan.h
        assert (blocks[:h, 1] == np.arange(h)).all() and (blocks[:h, 2] == 0).all()


@pytest.mark.parametrize("mask", PLAN_MASKS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_bwd_plan_streams_every_visible_pair(shape, mask):
    """Every visible (query, key) pair lies in a streamed tile of the block
    that owns its key (dK/dV) and of the block that owns its query row
    (dQ), and each pass's blocks stream no tile without one."""
    plan = _plan(shape, mask)
    vis = _visible(plan)
    t, u = plan.own_tile, plan.stream_tile
    for dq in (False, True):
        blocks = fa.bwd_blocks(plan, dq)
        own = blocks[blocks[:, 1] + blocks[:, 2] == 0]  # head 0, batch 0: one block per tile
        first, steps = fa._streamed_tiles(plan, own[:, 0], dq)
        for tile, lo, n in zip(own[:, 0], first, steps):
            mine = vis[tile * t:(tile + 1) * t] if dq else vis[:, tile * t:(tile + 1) * t].T
            cols = np.flatnonzero(mine.any(axis=0))  # the other pass's rows it must see
            covered = np.zeros(mine.shape[1], bool)
            covered[lo * u:(lo + n) * u] = True
            assert covered[cols].all()
            tiles_used = {c // u for c in cols}
            assert n == (len(range(min(tiles_used), max(tiles_used) + 1)) if cols.size else 0)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_bwd_plan_scratch_and_launches(shape):
    """At G > 1 the bf16 route adds a float32 (2, B, S_kv, H, D) scratch
    (each query head's dK and dV) and the pass that sums it; at G = 1 and
    on the float32 route there is neither.  qwen2-vl-2b's 2 x 4096 carries
    ~100 MB of it."""
    b, s_q, s_kv, h, kv, d, off = shape
    plan = _plan(shape, "causal")
    grouped = h > kv
    assert plan.kernels == ("delta_kernel", "dkdv_sm90_kernel",
                            *(("dkdv_sum_kernel",) if grouped else ()), "dq_sm90_kernel")
    assert plan.scratch_shape == ((2, b, s_kv, h, d) if grouped else None)
    assert plan.scratch_bytes == (8 * b * s_kv * h * d if grouped else 0)
    if grouped:
        assert plan.grids[2] == (-(-b * s_kv * kv * d // 4 // 256), 1, 1)
    f32 = _plan(shape, "causal", torch.float32)
    assert f32.kernels == ("delta_kernel", "dkdv_fma_kernel", "dq_fma_kernel")
    assert f32.grids[1:] == ((-(-s_kv // 32), kv, b), (-(-s_q // 32), h, b))
    assert f32.scratch_shape is None and f32.scratch_bytes == 0
    qwen = fa.bwd_plan(2, 4096, 4096, 12, 2, 128, causal=True, window=0, q_offset=0,
                       dtype=torch.bfloat16)
    assert qwen.scratch_bytes == 2 * 2 * 4096 * 12 * 128 * 4 == 100_663_296
    assert (qwen.dkdv_blocks, qwen.dq_blocks) == (768, 768)
    with pytest.raises(ValueError, match="float32 route"):
        fa.bwd_blocks(f32, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_meta_backward_peak_counts_the_scratch(shape, dtype):
    """One backward call on ``meta`` allocates what a launch does: its
    counted peak is the arguments, dq, dk, dv, the Δ scratch and the plan's
    dK/dV scratch, all live at once."""
    from repro_torch.launch import dryrun

    b, s_q, s_kv, h, kv, d, off = shape
    kw = dict(causal=True, window=0, q_offset=off)
    q, out, dout = (torch.empty((b, s_q, h, d), dtype=dtype, device="meta") for _ in range(3))
    k, v = (torch.empty((b, s_kv, kv, d), dtype=dtype, device="meta") for _ in range(2))
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device="meta")
    counter, grads, arg_bytes = dryrun.count(
        lambda *args: fa._meta_bwd(*args, **kw), q, k, v, out, lse, dout)
    plan = fa.bwd_plan(b, s_q, s_kv, h, kv, d, dtype=dtype, **kw)
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    assert counter.peak == arg_bytes + grad_bytes + lse.numel() * 4 + plan.scratch_bytes
    assert counter.kernels == {"flash_attention_bwd": 1}
