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
