"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or any module of the JAX package."""
import pathlib
import re

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s)"
    r"|from\s+repro\s+import)", re.MULTILINE)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_pattern_catches_reference_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "from repro.core import agents", "import repro.models", "from repro import core",
                 "import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import agents", "# jax is absent"):
        assert not FORBIDDEN.search(line), line
