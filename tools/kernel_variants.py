"""Build variant copies of one of the port's CUDA sources, each into a
library of its own beside the other sources, for the tools that time them
side by side (``flash_bwd_variants.py``, ``ssd_bwd_variants.py``).

A variant is a list of text replacements of ``source`` (each must occur),
or ``{"source": path, "replace": [...]}`` to start from another copy of the
file (an earlier revision, say); other keys of that dict are the tool's.
Every source is compiled with the port's nvcc flags under
``build/variants/``, one nvcc each, all started together.  For each variant
the ptxas registers and spills of the kernels whose names match
``kernel_re`` (its first group names the kernel, a second, if any, its
template argument) are printed, and the SASS counts of HGMMA and of
local-memory loads and stores (LDL, STL).  Needs nvcc.
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]


def build(source: Path, variants: dict, kernel_re: str) -> dict[str, Path]:
    out = _build.build_root().parent / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, flags = _build.nvcc(), list(_build.NVCC_FLAGS)
    jobs = {s.stem: (s, out / f"{s.stem}.o") for s in _build.SOURCES if s != source}
    for name, spec in variants.items():
        spec = spec if isinstance(spec, dict) else {"replace": spec}
        text = (ROOT / spec["source"]).read_text() if "source" in spec else source.read_text()
        for old, new in spec.get("replace", []):
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(text)
        jobs[f"v:{name}"] = (src, out / f"{name}.o")
    procs = {k: subprocess.Popen([nvcc, *flags, "-I", str(source.parent), "-c", str(s), "-o",
                                  str(o)], text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, (s, o) in jobs.items()}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    bad = [k for k, p in procs.items() if p.returncode]
    if bad:
        raise RuntimeError("\n".join(logs[k] for k in bad))
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    objs = [str(o) for key, (_, o) in jobs.items() if not key.startswith("v:")]
    libs = {}
    for name in variants:
        print(f"== {name}")
        kernel = None
        for line in logs[f"v:{name}"].splitlines():
            m = re.search(r"Function properties for \S*?" + kernel_re, line)
            if m:
                kernel = m.group(1) + (f"<{m.group(2)}>" if m.lastindex > 1 and m.group(2) else "")
            elif kernel and ("spill" in line or "registers" in line):
                print(f"  {kernel}: {line.strip()}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(out / f"{name}.o")],
                              capture_output=True, text=True).stdout
        counts, kernel = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : \S*?" + kernel_re, line)
            if m:
                kernel = m.group(1)
            elif kernel:
                for op in ("HGMMA", "LDL", "STL"):
                    if re.search(rf"\b{op}\b", line):
                        counts.setdefault(kernel, dict.fromkeys(("HGMMA", "LDL", "STL"), 0))
                        counts[kernel][op] += 1
        for k, c in counts.items():
            print(f"  {k}: sass {c}")
        libs[name] = out / f"lib{name}.so"
        subprocess.run([nvcc, "-shared", *objs, str(out / f"{name}.o"), "-o", str(libs[name])],
                       check=True)
    return libs
