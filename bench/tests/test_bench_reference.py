"""The plain reference against the port at its reduced widths on the CPU,
both in float32 on the same weights; the weights' initialisation; the
faults and the control the training cell's comparison has to catch."""
from __future__ import annotations

import json
import math
import statistics

import pytest
import torch

from bench import harness, weights
from bench.drivers import train
from bench.reference import mamba2 as ref_mamba
from bench.tools.control import FAULTS
from support import CELL, reduced_context, reduced_model

BENCH = harness.load_benchmark()
LIMITS = json.loads((harness.ROOT / "bench" / "limits" / f"{CELL}.json").read_text())


def _model(name: str) -> dict:
    conf = harness.config_of(BENCH, harness.find_cell(BENCH, CELL))
    return reduced_model(name, conf["models"][name])


def _program(name: str):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    return build_model(get_config(name, reduced=True))


def _f32(tree):
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.float(), tree)


def test_training_loss_and_gradients_match_the_port():
    name = "mamba2-370m"
    m = _model(name)
    api = _program(name)
    params = _f32(weights.make_model(5, name, m, "cpu"))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, m["vocab_size"], (2, 33), generator=gen)
    tokens, labels = ids[:, :-1], ids[:, 1:]
    from bench.drivers.train import leaf_paths
    from repro_torch.training.train_step import loss_and_grads

    loss, _, grads = loss_and_grads(api, params, {"tokens": tokens, "labels": labels})
    mine = ref_mamba.initial_params(5, name, m, "cpu")
    leaves = {k: v.requires_grad_() for k, v in mine.items()}
    nll = ref_mamba.nll_sum(leaves, m, tokens, labels, False) / labels.numel()
    assert float(loss) == pytest.approx(float(nll), rel=1e-5)
    want = dict(zip(leaves, torch.autograd.grad(nll, list(leaves.values()))))
    for path, g in zip(leaf_paths(params), grads):
        w = want[path]
        assert (g - w).abs().max() <= 1e-4 * w.abs().max() + 1e-9, path


def test_weights_follow_mamba2s_initialisation():
    """Each kind of leaf in its published range, the group drawn again bit
    for bit."""
    m = dict(_model("mamba2-370m"), num_layers=4)
    flat = {}
    for group, leaves in weights.layout(m).items():
        flat.update(weights.make_group(11, "mamba2-370m", group, leaves, "cpu"))
    d, di = m["d_model"], m["ssm_expand"] * m["d_model"]
    w_in = flat["blocks.0.ssm.w_in"].float()
    assert w_in.abs().max() <= 1 / math.sqrt(d) and w_in.std() > 0.5 / math.sqrt(3 * d)
    w_out = flat["blocks.0.ssm.w_out"].float()
    assert w_out.abs().max() <= 1 / math.sqrt(di) / math.sqrt(4) * 1.01
    assert flat["blocks.1.ssm.conv_b"].float().abs().max() <= 0.5
    dt = torch.nn.functional.softplus(flat["blocks.2.ssm.dt_bias"].float())
    assert dt.min() >= 0.99e-3 and dt.max() <= 0.101
    a = torch.exp(flat["blocks.3.ssm.A_log"].float())
    assert a.min() >= 1.0 and a.max() <= 16.0
    assert (flat["blocks.0.ssm.D"] == 1).all() and (flat["final_norm.scale"] == 1).all()
    emb = flat["embed.embedding"].float()
    assert abs(float(emb.std()) - weights.EMBED_STD) < 0.002
    again = weights.make_group(11, "mamba2-370m", "layer.2", weights.layout(m)["layer.2"], "cpu")
    assert torch.equal(again["blocks.2.ssm.w_in"], flat["blocks.2.ssm.w_in"])
    other = weights.make_group(12, "mamba2-370m", "layer.2", weights.layout(m)["layer.2"], "cpu")
    assert not torch.equal(other["blocks.2.ssm.w_in"], flat["blocks.2.ssm.w_in"])


def _r(names, first_grad, first_diff, change, change_diff, raw=None, parts=None):
    """The reference's readings; each leaf its own single part unless
    ``parts`` gives (names, norms, diffs)."""
    part_names, part_grad, part_diff = parts or (names, first_grad, first_diff)
    return {"names": names, "loss": [2.0, 1.9], "first_grad": first_grad,
            "raw_grad": raw or first_grad, "first_diff": first_diff, "change": change,
            "change_diff": change_diff, "part_names": part_names, "part_grad": part_grad,
            "part_diff": part_diff}


def test_readings_take_each_leaf_over_its_norm_or_the_median():
    names = ["embed.lm_head", "blocks.0.ssm.w_in", "blocks.1.ssm.w_in", "blocks.0.ssm.D"]
    r = _r(names, [2.0, 1.0, 1.0, 0.01], [0.2, 0.1, 0.3, 0.005],
           [0.5, 0.2, 0.2, 0.0], [0.05, 0.02, 0.04, 0.0])
    prog = {"loss": [2.02, 1.9], "first_grad": dict(zip(names, [2.2, 1.0, 0.9, 0.02])),
            "change": dict(zip(names, [0.5, 0.3, 0.2, 0.0]))}
    v, detail = train.readings(r, prog)
    assert v["loss_gap"] == pytest.approx(0.01)
    # the median leaf's norm is 1.0: D's gap 0.01 over 1.0, the head's 0.2 over 2
    assert v["grad_gap"] == pytest.approx(0.1)
    assert v["grad_diff"] == pytest.approx(statistics.median([0.1, 0.1, 0.3, 0.005]))
    # each part over its own norm: the head 0.1, the w_in's median 0.2, D 0.5
    assert v["grad_diff_part"] == pytest.approx(0.5)
    assert v["grad_diff_worst"] == pytest.approx(0.3)
    # the median change above zero is 0.2; D's zero change and zero diff read 0
    assert v["change_gap"] == pytest.approx(0.5)
    assert v["change_diff"] == pytest.approx(0.2)
    assert detail["left_out"] == [] and detail["grad_diff_by_part"]["ssm.D"] == 0.5


def test_grad_diff_part_reads_each_part_over_its_own_norm():
    """A part far smaller than the median leaf, gone wrong whole, reads 1;
    a part under a thousandth of the median leaf's norm is left out."""
    names = ["embed.lm_head", "blocks.0.ssm.w_in", "blocks.0.ssm.D"]
    parts = (["embed.lm_head", "blocks.0.ssm.w_in[x]", "blocks.0.ssm.w_in[B]",
              "blocks.0.ssm.D"], [2.0, 1.0, 0.01, 1e-5], [0.02, 0.01, 0.01, 1e-5])
    r = _r(names, [2.0, 1.0, 1e-5], [0.02, 0.01, 1e-5], [0.1, 0.1, 0.1], [0.0, 0.0, 0.0],
           parts=parts)
    prog = {"loss": [2.0, 1.9], "first_grad": dict(zip(names, [2.0, 1.0, 1e-5])),
            "change": dict(zip(names, [0.1, 0.1, 0.1]))}
    v, detail = train.readings(r, prog)
    assert v["grad_diff_part"] == pytest.approx(1.0)
    assert detail["grad_diff_by_part"]["ssm.w_in[x]"] == pytest.approx(0.01)
    assert detail["parts_left_out"] == ["blocks.0.ssm.D"]


def test_parts_split_the_in_projection_and_the_conv_by_role():
    m = _model("mamba2-370m")
    di, n = m["ssm_expand"] * m["d_model"], m["ssm_state_dim"]
    w_in = torch.arange(m["d_model"] * (2 * di + 2 * n + di // m["ssm_head_dim"])).reshape(
        m["d_model"], -1)
    got = ref_mamba.split_parts("blocks.1.ssm.w_in", w_in, m)
    assert [k for k, _ in got] == [f"blocks.1.ssm.w_in[{p}]" for p in ("z", "x", "B", "C", "dt")]
    assert torch.equal(torch.cat([t for _, t in got], dim=-1), w_in)
    assert [t.shape[-1] for _, t in got][2:4] == [n, n]
    conv = ref_mamba.split_parts("blocks.0.ssm.conv_b", torch.zeros(di + 2 * n), m)
    assert [t.numel() for _, t in conv] == [di, n, n]
    assert ref_mamba.split_parts("blocks.0.ssm.D", torch.zeros(3), m)[0][0] == "blocks.0.ssm.D"


def test_readings_leave_out_leaves_that_move_by_round_off():
    names = ["a", "b", "c"]
    r = _r(names, [1.0, 1.0, 1e-6], [0.0, 0.0, 0.0], [0.1, 0.1, 0.1], [0.0, 0.0, 5.0])
    prog = {"loss": [2.0, 1.9], "first_grad": dict(zip(names, [1.0, 1.0, 1e-6])),
            "change": dict(zip(names, [0.1, 0.1, 9.0]))}
    v, detail = train.readings(r, prog)
    assert detail["left_out"] == ["c"] and v["change_diff"] == 0.0 and v["change_gap"] == 0.0


# -- the faults the comparison has to catch ------------------------------------------

@pytest.mark.parametrize("seed", [12, 13, 14])
@pytest.mark.parametrize("fault", list(FAULTS[CELL]))
def test_a_planted_fault_is_not_correct(monkeypatch, fault, seed):
    """The whole run (the chip check aside) with the timed path broken
    underneath: the cell's own limits must call it not correct."""
    from bench.run import execute

    res = execute(reduced_context(monkeypatch, seed=seed, trace=True, **FAULTS[CELL][fault]))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("seed", [12, 13, 14])
def test_sound_runs_are_correct(monkeypatch, seed):
    from bench.run import execute

    res = execute(reduced_context(monkeypatch, seed=seed, trace=True))
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_control_reads_above_the_program(monkeypatch, seed):
    """The reference in float8 in the program's place: every compared
    number reads above the program's, and the control is not correct (on
    the card ``bench/tools/control.py`` reads it at the cell's size)."""
    from bench.run import execute

    prog = execute(reduced_context(monkeypatch, seed=seed, trace=True))["_side"]["detail"]["readings"]
    ctrl = execute(reduced_context(monkeypatch, seed=seed, trace=True, control=True))
    for k in LIMITS["limits"]:
        assert ctrl["_side"]["detail"]["readings"][k] > prog[k], (k, prog, ctrl["checks"])
    assert ctrl["correct"] is False, ctrl["checks"]


def test_limits_file_states_its_readings():
    assert set(LIMITS["limits"]) and LIMITS["why"]
    values, _ = train.readings(_r(["a"], [1.0], [0.0], [1.0], [0.0]),
                               {"loss": [2.0, 1.9], "first_grad": {"a": 1.0},
                                "change": {"a": 1.0}})
    assert set(LIMITS["limits"]) <= set(values)
