"""The frozen counts against sums worked by hand at two small shapes each."""
from bench import counts

DENSE = {"family": "dense", "num_layers": 1, "num_heads": 2, "head_dim": 2,
         "sliding_window": 0}


def test_causal_pairs():
    # 4 queries: 1 + 2 + 3 + 4; in a window of 2: 1 + 2 + 2 + 2
    assert counts.causal_pairs(4) == 10
    assert counts.causal_pairs(4, 2) == 7
    # a window wider than the prompt changes nothing
    assert counts.causal_pairs(5, 8) == 15


def test_ssd_fwd_and_bwd():
    # b=1 s=4 h=2 p=2 n=3 chunk=2: 2 chunks
    # C·Bᵀ: 2·2·2·3·1·2 = 48; per head: 2·2·(2·2 + 2·3·2)·1·2·2 = 256
    # bytes: x and y 2·4·2·2·2 = 64, dt 4·2·4 = 32, B and C 2·4·3·2 = 48, state 2·2·3·4 = 48
    assert counts.ssd_fwd(1, 4, 2, 2, 3, chunk=2) == (304.0, 192.0)
    # backward: twice the products; x, dy, dx 3·16·2 = 96, dt, ddt 2·8·4 = 64, B C dB dC 4·12·2 = 96
    assert counts.ssd_bwd(1, 4, 2, 2, 3, chunk=2) == (608.0, 256.0)
    # b=2 s=5 h=1 p=4 n=2 chunk=4: 2 chunks (the last padded)
    # C·Bᵀ 2·4·4·2·2·2 = 256; per head 2·4·(4·4 + 2·2·4)·2·1·2 = 1024
    # bytes: x, y 2·2·5·4·2 = 160, dt 2·5·4 = 40, B, C 2·2·5·2·2 = 80, state 2·4·2·4 = 64
    assert counts.ssd_fwd(2, 5, 1, 4, 2, chunk=4) == (1280.0, 344.0)
    assert counts.ssd_bwd(2, 5, 1, 4, 2, chunk=4, h0=True) == (2560.0, 240 + 80 + 160 + 128)


def test_train_step_flops():
    # 6·N·B·S, plus 12·L·B·H·D·S(S+1)/2 for attention
    assert counts.train_flops(DENSE, 100, 1, 3) == 1800 + 12 * 1 * 1 * 2 * 2 * 6
    ssm = {"family": "ssm"}
    assert counts.train_flops(ssm, 100, 2, 8) == 9600
    # mamba2-370m at 8 x 4096: 6 · 420.1M · 32,768 tokens
    assert counts.train_flops(ssm, 420_136_448, 8, 4096) == 6.0 * 420_136_448 * 32768


def test_bound_takes_the_larger_term():
    assert counts.bound_s(989e12, 0) == 1.0
    assert counts.bound_s(0, 3.35e12) == 1.0
    assert counts.bound_s(989e12, 6.7e12) == 2.0
