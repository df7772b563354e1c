"""Agent profiles derived from dry-run artifacts (repro_torch.core.profiles)
against the reference's ``repro.core.profiles`` on the same artifact JSON."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import profiles as jax_profiles  # noqa: E402
from repro.launch.mesh import HW as JAX_HW  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline  # noqa: E402

CARD = mesh.hw()  # the data sheet without a card

# (arch, roofline terms in s, bottleneck, dry-run argument bytes or None):
# R_i unclamped on both sides, clamped at 0.9 on one or both, at the 0.02
# floor, and without a dry-run artifact (parameters alone).
CASES = [
    ("granite-8b", {"compute": 0.002, "memory": 0.19, "collective": 0.0}, "memory", 8.0e9),
    ("qwen2-vl-2b", {"compute": 0.004, "memory": 0.03, "collective": 0.01}, "memory", 2.0e9),
    ("mixtral-8x7b", {"compute": 0.09, "memory": 0.07, "collective": 0.0}, "compute", 50.0e9),
    ("llama3-405b", {"compute": 0.1, "memory": 0.9, "collective": 0.0}, "memory", 900e9),
    ("mamba2-370m", {"compute": 1e-4, "memory": 0.015, "collective": 0.0}, "memory", 0.2e9),
    ("minitron-4b", {"compute": 0.003, "memory": 0.17, "collective": 0.0}, "memory", None),
]


def _write(tmp_path, arch, terms, bottleneck, arg_bytes):
    """One artifact under both packages' names."""
    roof, dry = tmp_path / "roofline", tmp_path / "dryrun"
    roof.mkdir(exist_ok=True)
    dry.mkdir(exist_ok=True)
    r = {"arch": arch, "shape": "decode_32k", "chips": 1, "roofline_s": terms,
         "bottleneck": bottleneck}
    for tag in ("pod1", mesh.TAG):
        (roof / f"{arch}_decode_32k_{tag}.json").write_text(json.dumps(r))
        if arg_bytes is not None:
            (dry / f"{arch}_decode_32k_{tag}.json").write_text(
                json.dumps({"per_device": {"argument_bytes": arg_bytes}}))
    return {"root": str(roof), "dryrun_root": str(dry)}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_profile_matches_reference_on_the_same_artifact(tmp_path, case):
    """T and M equal; R is the reference's scaled by the ratio of the two
    memories (its TPU's 16 GiB to the card's) where neither clamps,
    both rounded to 4 decimals."""
    arch, terms, bottleneck, arg_bytes = case
    roots = _write(tmp_path, arch, terms, bottleneck, arg_bytes)
    got = profiles.profile_arch(arch, **roots)
    want = jax_profiles.profile_arch(arch, **roots)
    assert got["throughput_tokens_per_s"] == want["throughput_tokens_per_s"]
    assert got["model_mb"] == want["model_mb"]
    assert got["step_s"] == want["step_s"] and got["bottleneck"] == want["bottleneck"]
    raw = (arg_bytes or got["model_mb"] * 2**20) / CARD["hbm_bytes"]
    if 0.02 < raw < 0.9:
        ref_raw = (arg_bytes or got["model_mb"] * 2**20) / JAX_HW["hbm_bytes"]
        if ref_raw < 0.9:
            assert got["min_gpu"] == pytest.approx(
                want["min_gpu"] * JAX_HW["hbm_bytes"] / CARD["hbm_bytes"], abs=1e-4)
        assert got["min_gpu"] == pytest.approx(raw, abs=5e-5)
    else:
        assert got["min_gpu"] == (0.9 if raw >= 0.9 else 0.02)


def test_fleet_and_available_archs(tmp_path):
    for case in CASES:
        roots = _write(tmp_path, *case)
    archs = profiles.available_archs(roots["root"])
    assert archs == sorted(c[0] for c in CASES)
    assert archs == jax_profiles.available_archs(roots["root"])
    pri = {a: 1 + i % 2 for i, a in enumerate(archs[:4])}
    fleet = profiles.fleet_from_archs(pri, **roots)
    fleet.validate()
    want = jax_profiles.fleet_from_archs(pri, **roots)
    assert fleet.names == want.names
    np.testing.assert_array_equal(fleet.base_throughput.numpy(), np.asarray(want.base_throughput))
    np.testing.assert_array_equal(fleet.model_size_mb.numpy(), np.asarray(want.model_size_mb))
    np.testing.assert_array_equal(fleet.priority.numpy(), np.asarray(want.priority))
    with pytest.raises(FileNotFoundError):
        profiles.fleet_from_archs({"deepseek-67b": 1}, **roots)


def test_derived_at_the_engine_shape_from_the_ports_own_runs(tmp_path):
    """The dry-run and the roofline of qwen2-vl-2b at the engine's decode
    shape on meta, written where ``profile_arch`` reads them: its batch is
    the shape's 4 rows, its R the step's parameters and cache over the
    card's memory."""
    shape = profiles.ENGINE_DECODE
    assert (shape.global_batch, shape.seq_len, shape.mode) == (4, 1024, "decode")
    roots = {"root": str(tmp_path / "roofline"), "dryrun_root": str(tmp_path / "dryrun")}
    for root, fn in ((roots["root"], roofline.run_one), (roots["dryrun_root"], dryrun.run_one)):
        res = fn("qwen2-vl-2b", shape, card=CARD)
        (tmp_path / root).mkdir(exist_ok=True)
        (tmp_path / root / f"qwen2-vl-2b_{shape.name}_{mesh.TAG}.json").write_text(
            json.dumps(res))
    p = profiles.profile_arch("qwen2-vl-2b", shape=shape, **roots)
    roof = profiles.load_roofline("qwen2-vl-2b", shape, roots["root"])
    assert p["throughput_tokens_per_s"] == pytest.approx(4 / max(roof["roofline_s"].values()))
    dry = json.loads((tmp_path / "dryrun" / f"qwen2-vl-2b_{shape.name}_{mesh.TAG}.json")
                     .read_text())
    assert p["min_gpu"] == round(dry["per_device"]["argument_bytes"] / CARD["hbm_bytes"], 4)
    assert 0.02 < p["min_gpu"] < 0.9
    assert profiles.profile_arch("qwen2-vl-2b", **roots) is None  # no decode_32k artifact
