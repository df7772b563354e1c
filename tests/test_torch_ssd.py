"""The port's plain SSD scan against the JAX package's plain versions and its
Pallas kernel (run in interpret mode, as tests/test_kernels.py runs it),
plus the dispatch rules of ``repro_torch.kernels.ssd.ops``."""
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
