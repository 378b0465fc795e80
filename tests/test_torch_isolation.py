"""The port stands alone: no ``repro_torch`` module imports ``jax`` or
``repro``, even in a process where JAX cannot load."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

SRC = Path(repro_torch.__file__).resolve().parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)", re.M)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(SRC)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.exec.fragment" in mods
    assert "repro_torch.kernels.ops" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and (m in ('jax', 'repro')\n"
        "                  or m.startswith(('jax.', 'repro.'))))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(SRC.parent)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout


def test_no_source_line_imports_jax_or_repro():
    offenders = []
    for path in sorted(SRC.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if FORBIDDEN.match(line):
                offenders.append(f"{path.relative_to(SRC)}:{i}: {line}")
    assert not offenders, offenders


def test_forbidden_pattern_catches_what_it_should():
    assert FORBIDDEN.match("import jax")
    assert FORBIDDEN.match("    from repro.exec import lower")
    assert FORBIDDEN.match("from jax.experimental import pallas as pl")
    assert not FORBIDDEN.match("from repro_torch.exec import lower")
    assert not FORBIDDEN.match("import jaxlib_like_name_is_fine")
