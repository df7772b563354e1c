"""The SSD scan's backward: the port's plain chunked backward
(``ref.ssd_bwd_plain``) against ``jax.vjp`` of the JAX package's
``ref.ssd_chunked`` (the gradient ``jax.grad`` takes, since the Pallas
kernel has no ``custom_vjp``) and against native autograd of the port's
``ref.ssd_chunked``, and ``SsdScanFn`` (the autograd Function the kernels
sit in on the card) with the plain versions injected as its kernels."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels.ssd import ref as jax_ref
from repro_torch.kernels.ssd import ref, ssd_scan

# tests/test_kernels.py's SSD float32 tolerance, 1e-4, taken over each
# input's max|g|: the gradients reach ~300 at these cases (dA sums every
# position), where float32 sums in another order already differ by ~1e-3
# (native autograd against jax.vjp: up to 5e-6 of max|g|).
RTOL = 1e-4
NAMES = ("x", "dt", "A", "Bm", "Cm", "D", "h0")

# tests/test_kernels.py's SSD cases, then test_ssd_initial_state's (with h0).
CASES = [
    # (b, s, h, p, n, chunk, h0)
    (2, 128, 4, 32, 16, 32, False),
    (1, 96, 2, 64, 32, 32, False),
    (2, 64, 8, 16, 8, 16, False),
    (1, 100, 2, 32, 16, 32, False),  # non-divisible seq (padding path)
    (1, 64, 2, 16, 8, 16, True),
]
IDS = ["-".join(map(str, c)) for c in CASES]


def _inputs(case, seed=0, dh_final=True):
    """float32 numpy inputs built as tests/test_kernels.py builds them (h0
    only where the case has it), and the cotangents of y and of the final
    state (zero without ``dh_final``)."""
    b, s, h, p, n, _, with_h0 = case
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = rand(b, s, h, p) * 0.5
    dt = np.logaddexp(0.0, rand(b, s, h)).astype(np.float32)   # softplus
    A = -np.exp(rand(h) * 0.3)
    Bm, Cm = rand(b, s, n), rand(b, s, n)
    D = np.ones((h,), np.float32)
    h0 = rand(b, h, p, n) if with_h0 else None
    dy = rand(b, s, h, p)
    dh = rand(b, h, p, n) if dh_final else np.zeros((b, h, p, n), np.float32)
    return [x, dt, A, Bm, Cm, D, h0], dy, dh


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _gaps(got, want) -> dict:
    """Each input's largest gap over its gradient's max|g|."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        out[name] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return out


@pytest.mark.parametrize("dh_final", [False, True], ids=["dh_final_zero", "dh_final_random"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_bwd_plain_matches_jax_vjp(case, dh_final):
    chunk = case[5]
    args, dy, dh = _inputs(case, dh_final=dh_final)
    given = [a for a in args if a is not None]

    def fn(*a):
        return jax_ref.ssd_chunked(*a[:6], h0=a[6] if len(a) > 6 else None, chunk=chunk)

    @jax.jit
    def vjp(args, cots):
        return jax.vjp(fn, *args)[1](cots)

    want = vjp(tuple(map(jnp.asarray, given)), (jnp.asarray(dy), jnp.asarray(dh)))
    got = ref.ssd_bwd_plain(*map(_t, args), _t(dy), _t(dh), chunk=chunk)
    assert (got[6] is None) == (args[6] is None)
    got = [g for g in got if g is not None]
    assert [tuple(g.shape) for g in got] == [a.shape for a in given]
    assert all(g.dtype == torch.float32 for g in got)
    gaps = _gaps([g.numpy() for g in got], want)
    assert max(gaps.values()) <= RTOL, gaps


@pytest.mark.parametrize("half", [False, True], ids=["chunk", "half_chunk"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_bwd_plain_matches_native_autograd(case, half):
    """At the case's chunk and at half of it: the plain backward at one
    chunk is the gradient of the forward at any other."""
    chunk = case[5] // 2 if half else case[5]
    args, dy, dh = _inputs(case, seed=1)
    leaves = [None if a is None else _t(a).clone().requires_grad_() for a in args]
    y, hf = ref.ssd_chunked(*leaves[:6], h0=leaves[6], chunk=case[5])
    given = [t for t in leaves if t is not None]
    want = torch.autograd.grad([y, hf], given, [_t(dy), _t(dh)])
    got = [g for g in ref.ssd_bwd_plain(*map(_t, args), _t(dy), _t(dh), chunk=chunk)
           if g is not None]
    gaps = _gaps([g.numpy() for g in got], [w.numpy() for w in want])
    assert max(gaps.values()) <= RTOL, gaps


def test_ssd_bwd_plain_keeps_each_inputs_dtype():
    """bf16 x, B and C get bf16 gradients; dt, A, D and h0 float32."""
    args, dy, dh = _inputs(CASES[4])
    t = [_t(a) for a in args]
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    got = ref.ssd_bwd_plain(*t, _t(dy).to(torch.bfloat16), None, chunk=16)
    assert [g.dtype for g in got] == [a.dtype for a in t]


# (cotangents given, frozen inputs): y alone, y and the state, the state
# alone; A and D frozen as a caller may freeze them.
FN_CASES = [("y", ()), ("y_state", ()), ("state", ()), ("y", ("A", "D"))]


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("outs,frozen", FN_CASES, ids=["-".join((o,) + f) for o, f in FN_CASES])
def test_ssd_function_with_plain_kernels_matches_native_autograd(outs, frozen, with_h0):
    """``SsdScanFn`` with ``ref.ssd_chunked`` as its forward and
    ``ref.ssd_bwd_plain`` as its backward: the outputs bit for bit, the
    gradients within RTOL of native autograd's, every input that requires
    one given one, and None for the others."""
    case = (2, 100, 3, 16, 8, 32, with_h0)
    chunk = case[5]
    args, dy, dh = _inputs(case, seed=2)
    inputs = [_t(a) for a in args]

    def run(fn):
        leaves = [None if t is None else t.clone().requires_grad_(NAMES[i] not in frozen)
                  for i, t in enumerate(inputs)]
        y, hf = fn(leaves)
        pairs = {"y": [(y, _t(dy))], "state": [(hf, _t(dh))],
                 "y_state": [(y, _t(dy)), (hf, _t(dh))]}[outs]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], wanted, [c for _, c in pairs],
                                    allow_unused=True)
        # The final state reads neither C nor D: native autograd gives them
        # no gradient, the backward zeros.
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, wanted)]
        return (y.detach(), hf.detach()), grads, leaves

    (wy, wh), want, _ = run(lambda t: ref.ssd_chunked(*t[:6], h0=t[6], chunk=chunk))
    seen = []

    def bwd(*a, **kw):
        seen.append((a[7] is None, a[8] is None))
        return ref.ssd_bwd_plain(*a, **kw)

    (gy, gh), got, leaves = run(lambda t: ssd_scan.SsdScanFn.apply(
        lambda *a, **kw: ref.ssd_chunked(*a[:6], h0=a[6], **kw), bwd, {"chunk": chunk}, *t))
    assert torch.equal(gy, wy) and torch.equal(gh, wh)
    assert seen == [(outs == "state", outs == "y")]
    assert len(got) == sum(t is not None and t.requires_grad for t in leaves)
    gaps = _gaps([g.numpy() for g in got], [w.numpy() for w in want])
    assert max(gaps.values()) <= RTOL, gaps


def test_cost_backward_is_twice_the_forwards_products():
    b, s, h, p, n = 4, 4096, 32, 64, 128
    fwd = ssd_scan.cost(b, s, h, p, n, chunk=128, h0=False, dtype=torch.bfloat16)
    bwd = ssd_scan.cost_backward(b, s, h, p, n, chunk=128, h0=False, dtype=torch.bfloat16)
    assert bwd.flops == {torch.bfloat16: 2 * fwd.flops[torch.bfloat16]}
    # x, dy, dx; dt, ddt; B, C, dB, dC (bf16), no state.
    assert bwd.bytes == 3 * b * s * h * p * 2 + 2 * b * s * h * 4 + 4 * b * s * n * 2
    assert round(bwd.flops[torch.bfloat16] / 1e9, 1) == 52.6
    assert round(bwd.bytes / 1e6) == 222
    state = b * h * p * n * 4
    with_states = ssd_scan.cost_backward(b, s, h, p, n, chunk=128, h0=True, dtype=torch.bfloat16,
                                         dh_final=True)
    assert with_states.bytes == bwd.bytes + 3 * state   # h0, dh0, dh_final
    assert with_states.flops == bwd.flops


# The backward's launch plan (``ssd_scan.bwd_plan``).
PLAN_SHAPES = [(4, 4096), (1, 4096), (2, 300), (3, 64)]


@pytest.mark.parametrize("b, s", PLAN_SHAPES)
@pytest.mark.parametrize("h", [1, 3, 24, 32])
def test_bwd_plan_covers_every_chunk_head_and_batch_once(h, b, s):
    """At b batch rows and every length up to s (one ragged, one whole
    number of chunks each), so at each group the bf16 plan picks there, tail
    groups included, the gradient pass's blocks, decoded as the kernel
    decodes them, take every (chunk, head, batch row) once; the chunk state
    pass runs on the same grid.  Over the four shapes the plan picks every
    group it can pick for H heads."""
    groups = set()
    for nc in range(1, -(-s // ssd_scan.KERNEL_CHUNK) + 1):
        for length in sorted({max(1, nc * 64 - 37), nc * 64}):
            plan = ssd_scan.bwd_plan(b, length, h, 64, 128, torch.bfloat16)
            g = plan.group
            assert g == ssd_scan.bwd_group(b, length, h) and 1 <= g <= h
            want = {(c, hd, z) for c in range(nc) for hd in range(h) for z in range(b)}
            rows = ssd_scan.grads_blocks(plan)
            assert len(rows) == len(want) and set(map(tuple, rows.tolist())) == want, g
            assert plan.grids[0] == plan.grids[2] == (nc, -(-h // g), b)
            assert plan.groups == -(-h // g)
            groups.add(g)
    # Each shape's groups: one chunk-row count m = nc·b picks ⌈H / k⌉ heads
    # for k = min(H, ⌈132 / m⌉) groups.
    m_max = -(-s // ssd_scan.KERNEL_CHUNK) * b
    assert groups == {-(-h // min(h, -(-ssd_scan.BWD_MIN_BLOCKS // m)))
                      for m in range(b, m_max + 1, b)}
    if (b, s) == PLAN_SHAPES[0]:  # the shapes together: every group the plan can pick
        picked = {ssd_scan.bwd_group(bb, nc * 64, h) for bb, ss in PLAN_SHAPES
                  for nc in range(1, -(-ss // 64) + 1)}
        assert picked == {ssd_scan.bwd_group(1, m * 64, h)
                          for m in range(1, ssd_scan.BWD_MIN_BLOCKS + 1)}


def test_bwd_plan_picks_one_wave_of_blocks():
    """The default group: as many heads as the fewest groups that give
    ``BWD_MIN_BLOCKS`` (132, one wave) blocks allow (spreading the heads
    evenly can leave fewer groups); all 32 at mamba2-370m's 4 x 4096 (256
    blocks), 11 at 1 x 4096 (groups of 11, 11, 10: 192 blocks), one head a
    group where even that falls short."""
    assert ssd_scan.BWD_MIN_BLOCKS == 132
    assert ssd_scan.bwd_group(4, 4096, 32) == 32
    assert ssd_scan.bwd_plan(4, 4096, 32, 64, 128, torch.bfloat16).grids[2] == (64, 1, 4)
    assert ssd_scan.bwd_group(1, 4096, 32) == 11
    assert ssd_scan.bwd_group(1, 64, 32) == 1
    for b, s, h in [(4, 4096, 32), (1, 4096, 32), (2, 300, 24), (3, 1000, 3)]:
        nc = -(-s // ssd_scan.KERNEL_CHUNK)
        fewest = min(h, -(-ssd_scan.BWD_MIN_BLOCKS // (nc * b)))
        assert ssd_scan.bwd_group(b, s, h) == -(-h // fewest)


def test_bwd_plan_scratch_and_launches_at_mamba_width():
    """At mamba2-370m's 4 x 4096 (H 32, P 64, N 128): the bf16 plan's four
    kernels, its chunk states at 536.9 MB (the same bytes in float32 parts
    or in bf16 hi + lo planes), no (2, B, S, H, N) per-head dB/dC scratch:
    one group of all 32 heads needs no group scratch and its last pass is
    one block (dA, dD).  At 4 x 2048 the plan takes two groups of 16, which
    sum their dB and dC from 16.8 MB.
    The float32 route's plan is its four FMA launches with the per-head
    parts."""
    b, s, h, p, n = 4, 4096, 32, 64, 128
    nc = s // 64
    plan = ssd_scan.bwd_plan(b, s, h, p, n, torch.bfloat16)
    assert plan.route == "mma" and plan.kernels == (
        "ssd_bwd_states_sm90_kernel", "ssd_bwd_passing_sm90_kernel", "ssd_bwd_grads_sm90_kernel",
        "ssd_bwd_reduce_sm90_kernel")
    assert plan.scratch[0] == (2, b, h, nc, 64 * 128)
    assert round(4 * math.prod(plan.scratch[0]) / 1e6, 1) == 536.9
    assert plan.group == h and len(plan.scratch) == 3 and plan.grids[3] == (1, 1, 1)
    assert (2, b, s, h, n) not in plan.scratch
    assert plan.scratch_bytes == sum(4 * math.prod(x) for x in plan.scratch)
    halves = ssd_scan.bwd_plan(b, s // 2, h, p, n, torch.bfloat16)
    assert halves.group == 16 and halves.grids[2] == (nc // 2, 2, b)
    assert halves.scratch[0] == (2, b, h, nc // 2, 64 * 128)
    assert halves.scratch[3] == (2, 2, b, s // 2, n)
    assert round(4 * math.prod(halves.scratch[3]) / 1e6, 1) == 16.8
    assert halves.grids[3] == (b * s // 2 * n // 256 + 1, 1, 1)
    f32 = ssd_scan.bwd_plan(b, s, h, p, n, torch.float32)
    assert f32.route == "fma" and f32.kernels == (
        "ssd_bwd_states_kernel", "ssd_bwd_passing_kernel", "ssd_bwd_grads_kernel",
        "ssd_bwd_reduce_kernel")
    assert f32.grids == ((nc, h, b), (8, h, b), (nc, h, b), (b * s * n // 256 + 1, 1, 1))
    assert f32.scratch == ((2, b, h, nc, p, n), (b, h, nc), (2, b, s, h, n), (2, b, nc, h))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", [(2, 256, 32, 64, 128), (1, 100, 3, 16, 24)])
def test_meta_backward_peak_counts_the_plans_scratch(shape, dtype):
    """One backward call on ``meta`` allocates what a launch does: its
    counted peak is the arguments, the gradients and the plan's scratch,
    all live at once."""
    from repro_torch.launch import dryrun

    b, s, h, p, n = shape
    meta = dict(device="meta")
    x, dy = (torch.empty((b, s, h, p), dtype=dtype, **meta) for _ in range(2))
    dt = torch.empty((b, s, h), **meta)
    A, D = torch.empty((h,), **meta), torch.empty((h,), **meta)
    Bm, Cm = (torch.empty((b, s, n), dtype=dtype, **meta) for _ in range(2))
    counter, grads, arg_bytes = dryrun.count(
        lambda *args: ssd_scan._meta_bwd(*args[:6], None, args[6], None, chunk=64),
        x, dt, A, Bm, Cm, D, dy)
    plan = ssd_scan.bwd_plan(b, s, h, p, n, dtype)
    grad_bytes = sum(g.numel() * g.element_size() for g in grads if g is not None)
    assert counter.peak == arg_bytes + grad_bytes + plan.scratch_bytes
    assert counter.kernels == {"ssd_scan_bwd": 1}


# The bf16 backward kernels' rounding points (csrc/ssd_scan_bwd_sm90.cu),
# emulated: chunks of 64, the cumsum in double and each gate's difference
# rounded once before the exp; x, dy, B and C exact; every float32 operand
# of a product as bf16 hi + lo (x∘w and dy∘exp(cum) in the chunk states;
# H and G as the walk writes them; K and C·Bᵀ ∘ L), each part one product
# into the same float32 sum; dB and dC summed over each group's heads in
# head order and over the groups in order, then rounded to bf16 once, as
# dx is.
def _hi_lo(v):
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _emulate_bf16_bwd(x, dt, A, Bm, Cm, D, h0, dy, dh, group, q=64):
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = -s % q
    c = (s + pad) // q

    def chunks(t, per_head):   # (B, S, [H,] K) -> (B, C, H or 1, Q, K)
        t = torch.nn.functional.pad(t.float(), (0, 0) * (2 if per_head else 1) + (0, pad))
        t = t.reshape(b, c, q, *t.shape[2:])
        return t.permute(0, 1, 3, 2, 4) if per_head else t[:, :, None]

    xf, dyf, Bf, Cf = chunks(x, True), chunks(dy, True), chunks(Bm, False), chunks(Cm, False)
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)).reshape(b, c, q, h)
    dtf = dtf.permute(0, 1, 3, 2)
    cum = torch.cumsum((A.float()[None, None, :, None] * dtf).double(), -1)
    tot = cum[..., -1:]
    ecum, etail = torch.exp(cum.float()), torch.exp((tot - cum).float())
    mt = lambda t: t.transpose(-1, -2)  # noqa: E731
    # Chunk states' parts, then the walk, H and G as their hi + lo planes.
    xh, xl = _hi_lo(xf * (etail * dtf)[..., None])
    yh, yl = _hi_lo(dyf * ecum[..., None])
    part_h, part_g = mt(xh) @ Bf + mt(xl) @ Bf, mt(yh) @ Cf + mt(yl) @ Cf
    decay = torch.exp(tot[..., 0].float())[..., None, None]
    st = torch.zeros((b, h, p, n)) if h0 is None else h0.float()
    hs = []
    for ci in range(c):
        hs.append(st)
        st = decay[:, ci] * st + part_h[:, ci]
    g = torch.zeros((b, h, p, n)) if dh is None else dh.float()
    gs = [None] * c
    for ci in reversed(range(c)):
        gs[ci] = g
        g = decay[:, ci] * g + part_g[:, ci]
    (hh, hl), (gh, gl) = _hi_lo(torch.stack(hs, 1)), _hi_lo(torch.stack(gs, 1))
    # Each chunk's gradients.
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    seg = (cum[..., :, None] - cum[..., None, :]).float()
    gate = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    cb = Cf @ mt(Bf)
    k = gate * dtf[..., None, :] * (dyf @ mt(xf))
    kh, kl = _hi_lo(k)
    sh, sl = _hi_lo(gate * cb)
    d_c = ecum[..., None] * (dyf @ hh + dyf @ hl) + (kh @ Bf + kl @ Bf)
    d_b = (dtf * etail)[..., None] * (xf @ gh + xf @ gl) + (mt(kh) @ Cf + mt(kl) @ Cf)
    u = etail[..., None] * (Bf @ mt(gh) + Bf @ mt(gl)) + (mt(sh) @ dyf + mt(sl) @ dyf)
    dx = dtf[..., None] * u + D.float()[None, None, :, None, None] * dyf
    inter = ecum * (dyf * (Cf @ mt(hh) + Cf @ mt(hl))).sum(-1)
    ck = cb * k
    xu = (xf * u).sum(-1)
    dcum = ck.sum(-1).double() + inter.double() - dtf.double() * xu.double()
    side = (dtf.double() * xu.double() - ck.sum(-2).double()).sum(-1)
    dcum[..., -1] += torch.exp(tot[..., 0]) * ((gh + gl) * (hh + hl)).sum((-2, -1)).double() + side
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = (xu.double() + A.float().double()[None, None, :, None] * da).float()
    d_a = (dtf.double() * da).sum(-1).float().double().sum((0, 1)).float()
    d_d = (dyf * xf).sum(-1).sum(-1).float().double().sum((0, 1)).float()
    sums = []
    for which in (d_b, d_c):  # (B, C, H, Q, N): heads in order within a group, then groups
        total = torch.zeros_like(which[:, :, 0])
        for g0 in range(0, h, group):
            acc = torch.zeros_like(which[:, :, 0])
            for hd in range(g0, min(h, g0 + group)):
                acc = acc + which[:, :, hd]
            total = total + acc
        sums.append(total.reshape(b, c * q, n)[:, :s].to(Bm.dtype))
    def unchunk(t):  # (B, C, H, Q, ...) -> (B, S, H, ...)
        return t.transpose(2, 3).reshape(b, c * q, h, *t.shape[4:])

    return (unchunk(dx)[:, :s].to(x.dtype), unchunk(ddt[..., None])[:, :s, :, 0], d_a, sums[0],
            sums[1], d_d, None if h0 is None else g)


@pytest.mark.parametrize("group", [None, 8], ids=["plan", "g8"])
def test_bf16_backward_rounding_holds_the_card_tolerance(group):
    """The emulated bf16 backward at mamba2-370m's widths (H 32, P 64, N
    128) and 2 x 256 against the float32 plain backward of the same inputs
    upcast, within chip_smoke.py's phase 3b bf16 rule: max(2 × the bf16
    plain route's own gap, 2^-7) of each input's max|g|."""
    b, s, h, p, n = 2, 256, 32, 64, 128
    args, dy_np, _ = _inputs((b, s, h, p, n, 128, False), seed=3)
    t = [_t(a) for a in args]
    for i in (0, 3, 4):
        t[i] = t[i].bfloat16()
    dy = torch.from_numpy(dy_np).bfloat16()
    g = ssd_scan.bwd_plan(b, s, h, p, n, torch.bfloat16).group if group is None else group
    got = [v for v in _emulate_bf16_bwd(*t, dy, None, g) if v is not None]
    up = [None if a is None else a.float() for a in t]
    want = [v for v in ref.ssd_bwd_plain(*up, dy.float(), None, chunk=128) if v is not None]
    leaves = [a.clone().requires_grad_() for a in t[:6]]
    y, _ = ref.ssd_chunked(*leaves, chunk=128)
    plain = torch.autograd.grad(y, leaves, dy)

    def gap(u, v):
        return float((u.double() - v.double()).abs().max() / v.double().abs().max())

    tols = [max(2 * gap(pl, w), 2.0 ** -7) for pl, w in zip(plain, want)]
    gaps = [gap(u, w) for u, w in zip(got, want)]
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.bfloat16
    assert all(x <= tol for x, tol in zip(gaps, tols)), (dict(zip(NAMES, gaps)), tols)
