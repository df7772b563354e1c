"""The SSD scan's backward: the port's plain chunked backward
(``ref.ssd_bwd_plain``) against ``jax.vjp`` of the JAX package's
``ref.ssd_chunked`` (the gradient ``jax.grad`` takes, since the Pallas
kernel has no ``custom_vjp``) and against native autograd of the port's
``ref.ssd_chunked``, and ``SsdScanFn`` (the autograd Function the kernels
sit in on the card) with the plain versions injected as its kernels."""
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
