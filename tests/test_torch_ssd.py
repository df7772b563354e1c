"""The port's plain SSD scan against the JAX package's plain versions and its
Pallas kernel (run in interpret mode, as tests/test_kernels.py runs it),
the dispatch rules of ``repro_torch.kernels.ssd.ops``, the launch plan of
each dtype's route, and an emulation of the bf16 kernel's rounding points."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.ssd import ref as jax_ref
from repro.kernels.ssd.ssd_scan import ssd as pallas_ssd
from repro_torch.kernels.ssd import ops, ref, ssd_scan

ATOL = 1e-4  # float32 on both sides, as tests/test_kernels.py holds the scan

# The shape cases of tests/test_kernels.py.
SSD_CASES = [
    # (b, s, h, p, n, chunk)
    (2, 128, 4, 32, 16, 32),
    (1, 96, 2, 64, 32, 32),
    (2, 64, 8, 16, 8, 16),
    (1, 100, 2, 32, 16, 32),  # non-divisible seq (padding path)
]


def _inputs(b, s, h, p, n, seed=0, h0=False):
    """Built as tests/test_kernels.py builds them, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = rand(b, s, h, p) * 0.5
    dt = np.logaddexp(0.0, rand(b, s, h)).astype(np.float32)   # softplus
    A = -np.exp(rand(h) * 0.3)
    Bm, Cm = rand(b, s, n), rand(b, s, n)
    D = np.ones((h,), np.float32)
    out = [x, dt, A, Bm, Cm, D]
    if h0:
        out.append(rand(b, h, p, n))
    return out


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_jax_ref_and_pallas(case):
    b, s, h, p, n, chunk = case
    args = _inputs(b, s, h, p, n, seed=sum(case))
    t_args = [torch.from_numpy(a) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    naive = ref.ssd_naive(*t_args)
    chunked = ref.ssd_chunked(*t_args, chunk=chunk)
    _close(naive, jax_ref.ssd_naive(*j_args))
    _close(chunked, jax_ref.ssd_chunked(*j_args, chunk=chunk))
    _close(chunked, pallas_ssd(*j_args, chunk=chunk, interpret=True))
    _close(chunked, naive)


def test_ssd_initial_state_matches_jax():
    """tests/test_kernels.py::test_ssd_initial_state: SSD from h0 ==
    continuing the recurrence."""
    *args, h0 = _inputs(1, 64, 2, 16, 8, seed=9, h0=True)
    t_args = [torch.from_numpy(a) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    want = jax_ref.ssd_naive(*j_args, h0=jnp.asarray(h0))
    _close(ref.ssd_naive(*t_args, h0=torch.from_numpy(h0)), want)
    _close(ref.ssd_chunked(*t_args, h0=torch.from_numpy(h0), chunk=16), want)
    _close(ref.ssd_chunked(*t_args, h0=torch.from_numpy(h0), chunk=16),
           pallas_ssd(*j_args, h0=jnp.asarray(h0), chunk=16, interpret=True))


def test_decode_steps_match_the_full_scan_and_jax():
    """tests/test_kernels.py::test_ssd_decode_step_consistency, and each
    step against the JAX step."""
    b, s, h, p, n = 1, 8, 2, 16, 8
    x, dt, A, Bm, Cm, D = _inputs(b, s, h, p, n, seed=11)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)]
    want_y, want_h = ref.ssd_naive(*t)
    hstate, jstate = torch.zeros((b, h, p, n)), jnp.zeros((b, h, p, n))
    for i in range(s):
        y_t, hstate = ops.ssd_decode_step(t[0][:, i], t[1][:, i], t[2], t[3][:, i], t[4][:, i],
                                          t[5], hstate)
        jy, jstate = jax_ref.ssd_decode_step(x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i], D, jstate)
        _close((y_t, hstate), (jy, jstate))
    np.testing.assert_allclose(y_t.numpy(), want_y[:, -1].numpy(), atol=1e-5)
    np.testing.assert_allclose(hstate.numpy(), want_h.numpy(), atol=1e-5)


@pytest.mark.parametrize("chunk", [8, 32, 64, 128])
def test_chunked_scan_does_not_depend_on_the_chunk(chunk):
    """The kernel runs its own chunk length whatever the caller's: the
    function is the same."""
    t = [torch.from_numpy(a) for a in _inputs(2, 77, 3, 32, 16, seed=chunk)]
    _close(ref.ssd_chunked(*t, chunk=chunk), ref.ssd_naive(*t))


def test_bf16_inputs_round_where_the_reference_rounds():
    """bfloat16 x, B and C: float32 arithmetic, y cast back at the end."""
    args = _inputs(1, 48, 2, 32, 16, seed=4)
    args[0], args[3], args[4] = (a.astype(jnp.bfloat16) for a in (args[0], args[3], args[4]))
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    for i in (0, 3, 4):
        t[i] = t[i].bfloat16()
    y, h = ref.ssd_chunked(*t, chunk=16)
    jy, jh = jax_ref.ssd_chunked(*map(jnp.asarray, args), chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    # Both round a float32 y once: at most one bfloat16 step apart.
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=ATOL, rtol=2.0 ** -7)


def test_ops_on_cpu_tensors_take_the_plain_version():
    t = [torch.from_numpy(a) for a in _inputs(2, 70, 2, 32, 16)]
    before = ssd_scan.launches
    for got in (ops.ssd(*t, chunk=32), ssd_scan.ssd(*t, chunk=32)):
        want = ref.ssd_chunked(*t, chunk=32)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ssd_scan.launches == before


def test_explicit_kernel_route_raises_off_the_card():
    t = [torch.from_numpy(a) for a in _inputs(1, 16, 2, 16, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(*t, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.ssd(*t, impl="pallas")


@pytest.mark.parametrize("shape", [(1, 512, 32, 64, 128), (2, 100, 3, 32, 24), (1, 1, 2, 16, 8)])
def test_each_dtype_plans_its_own_kernel(shape):
    """bf16 -> the one-launch tensor-core kernel, one block per 16 P columns
    of each head and batch row, no scratch; float32 -> the three-pass FMA
    kernel with its chunk states in scratch; anything else raises."""
    b, s, h, p, n = shape
    mma = ssd_scan.plan(b, s, h, p, n, torch.bfloat16)
    assert (mma.route, mma.grid, mma.kernels, mma.scratch) == ("mma", (p // 16, h, b), 1, ())
    nc = -(-s // 64)
    fma = ssd_scan.plan(b, s, h, p, n, torch.float32)
    assert (fma.route, fma.grid, fma.kernels) == ("fma", (nc, h, b), 3)
    assert fma.scratch == ((b, h, nc, p, n), (b, h, nc))
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan.plan(b, s, h, p, n, torch.float16)


# The bf16 kernel's rounding points (csrc/ssd_scan_sm90.cu), emulated: chunks
# of 64, a_cum in double, the gate's exponent a_cum_t − a_cum_s in log2
# units from float hi + lo pairs, every product a bf16 x bf16 -> f32 tensor-core
# product, and the three float32 operands split into bf16 parts, one product
# each: the gated scores W into three, the weighted inputs x∘w and the
# carried state h into two.  The card's tolerance (chip_smoke.py's SSD_ATOL,
# SSD_WIDE_RTOL): y within 5e-2 beyond one bfloat16 step of |y| (2^-7), the
# final state within 5e-2.
CARD_ATOL, CARD_RTOL = 5e-2, 2.0 ** -7
KERNEL_PARTS = {"W": 3, "xw": 2, "h": 2}


def _parts(v, k):
    """``k`` bf16 values (as float32) whose sum is ``v`` to ~8k bits."""
    out = []
    for _ in range(k):
        out.append(v.bfloat16().float())
        v = v - out[-1]
    return out


def _emulate_bf16_route(x, dt, A, Bm, Cm, D, h0=None, parts=None, q=64):
    parts = parts or KERNEL_PARTS
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = -s % q
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    state = torch.zeros((b, h, p, n)) if h0 is None else h0.float().clone()
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    ys = []
    for c0 in range(0, s + pad, q):
        xc = xf[:, c0:c0 + q].transpose(1, 2)                        # (B,H,Q,P)
        d = dtf[:, c0:c0 + q].transpose(1, 2)                        # (B,H,Q)
        Bc, Cc = Bf[:, None, c0:c0 + q], Cf[:, None, c0:c0 + q]      # (B,1,Q,N)
        acum = torch.cumsum((A[None, :, None].float() * d).double(), -1)
        a_tot = acum[..., -1:]
        l2 = acum * math.log2(math.e)                                 # a_cum·log2(e) as hi + lo
        hi, lo = l2.float(), (l2 - l2.float().double()).float()
        seg = (hi[..., :, None] - hi[..., None, :]) + (lo[..., :, None] - lo[..., None, :])
        W = (Cc @ Bc.transpose(-1, -2)) * torch.where(tri, torch.exp2(torch.where(tri, seg, 0.0)),
                                                      0.0) * d[..., None, :]
        y_in = sum(w @ xc for w in _parts(W, parts["W"]))
        y_out = sum(Cc @ hp.transpose(-1, -2) for hp in _parts(state, parts["h"]))
        ys.append(y_in + torch.exp(acum.float())[..., None] * y_out
                  + D[None, :, None, None].float() * xc)
        xw = xc * (torch.exp((a_tot - acum).float()) * d)[..., None]
        state = (torch.exp(a_tot.float())[..., None] * state
                 + sum(xp.transpose(-1, -2) @ Bc for xp in _parts(xw, parts["xw"])))
    return torch.cat(ys, 2).transpose(1, 2)[:, :s].to(x.dtype), state


def _bf16_inputs(b, s, h, p, n, seed, h0=False):
    t = [torch.from_numpy(a) for a in _inputs(b, s, h, p, n, seed=seed, h0=h0)]
    for i in (0, 3, 4):
        t[i] = t[i].bfloat16()
    return t


def _excess(got, want):
    (gy, gh), (wy, wh) = got, want
    dy = (gy.float() - wy.float()).abs() - CARD_RTOL * wy.float().abs()
    return float(dy.max()), float((gh - wh).abs().max())


@pytest.mark.parametrize("case", [
    # (b, s, h, p, n, h0): mamba2-370m at S = 512, a ragged one with h0, small
    (1, 512, 32, 64, 128, False),
    (1, 129, 32, 64, 128, True),
    (2, 100, 3, 32, 24, True),
])
def test_bf16_route_rounding_holds_the_card_tolerance(case):
    *shape, with_h0 = case
    args = _bf16_inputs(*shape, seed=sum(shape), h0=with_h0)
    want = ref.ssd_chunked(*args[:6], h0=args[6] if with_h0 else None, chunk=128)
    got = _emulate_bf16_route(*args[:6], h0=args[6] if with_h0 else None)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    y_excess, h_err = _excess(got, want)
    assert y_excess <= CARD_ATOL and h_err <= CARD_ATOL, (y_excess, h_err)


def test_rounding_the_float32_operands_once_misses_the_card_tolerance():
    """Why W, x∘w and h go in as hi + lo pairs: rounded once to bf16, y at
    mamba2-370m's widths leaves the tolerance."""
    args = _bf16_inputs(1, 512, 32, 64, 128, seed=0)
    want = ref.ssd_chunked(*args, chunk=128)
    once = {"W": 1, "xw": 1, "h": 1}
    y_excess, _ = _excess(_emulate_bf16_route(*args, parts=once), want)
    assert y_excess > CARD_ATOL


def test_three_parts_of_w_bring_the_error_to_the_plain_versions_own():
    """Why W takes three parts: with two, y before its rounding to bf16 is
    ~2x further from a float64 scan than the float32 plain version is, and
    at |y| > 8 that flips elements by a whole bf16 step (0.0625 > 5e-2)."""
    args = [t.float() for t in _bf16_inputs(2, 128, 4, 32, 16, seed=1)]
    exact = ref.ssd_chunked(*[t.double() for t in args], chunk=64)[0]
    plain_err = float((ref.ssd_chunked(*args, chunk=32)[0].double() - exact).abs().max())

    def err(w_parts):
        y, _ = _emulate_bf16_route(*args, parts=dict(KERNEL_PARTS, W=w_parts))
        return float((y.double() - exact).abs().max())

    assert err(3) <= 1.5 * plain_err < err(2)
