"""The port stands alone: no ``repro_torch`` module imports ``jax``,
``repro`` or ``msgpack``, even in a process where none of them can load
(the card's machine has neither JAX nor msgpack; the port's stores go
through ``storage/msgpack_codec.py``)."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

SRC = Path(repro_torch.__file__).resolve().parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)", re.M)
MSGPACK = re.compile(r"^\s*(import|from)\s+msgpack\b", re.M)
# the training half of the model stack and the host tables
NEW_MODULES = ("repro_torch.optim.adamw", "repro_torch.checkpoint.store",
               "repro_torch.launch.train", "repro_torch.launch.specs",
               "repro_torch.analysis.memtraffic",
               "repro_torch.parallel.sharding", "repro_torch.tree")


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(SRC)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.exec.fragment" in mods
    assert "repro_torch.kernels.ops" in mods
    assert "repro_torch.service.service" in mods
    assert "repro_torch.launch.sql" in mods
    for m in NEW_MODULES:
        assert m in mods, m
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and (m in ('jax', 'repro', 'msgpack')\n"
        "                  or m.startswith(('jax.', 'repro.', 'msgpack.'))))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n"
        "need = ('repro_torch.service.service', 'repro_torch.launch.sql')\n"
        "print('IMPORTED', [m for m in need if m in sys.modules])\n"
        f"print('TRAINING', all(m in sys.modules for m in {NEW_MODULES!r}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(SRC.parent)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert "IMPORTED ['repro_torch.service.service', " \
        "'repro_torch.launch.sql']" in res.stdout
    assert "TRAINING True" in res.stdout


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


def test_no_source_line_imports_msgpack():
    offenders = []
    for path in sorted(SRC.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if MSGPACK.match(line):
                offenders.append(f"{path.relative_to(SRC)}:{i}: {line}")
    assert not offenders, offenders
    assert MSGPACK.match("import msgpack")
    assert not MSGPACK.match("from repro_torch.storage import msgpack_codec")


def test_the_service_ledger_writes_through_the_ports_codec():
    from repro_torch.service import ledger
    from repro_torch.storage import msgpack_codec
    assert ledger.msgpack is msgpack_codec


MODEL_STACK = ("repro_torch.models.moe", "repro_torch.models.model",
               "repro_torch.models.decode", "repro_torch.models.steps",
               "repro_torch.launch.serve")


def test_the_model_stack_imports_without_jax_or_repro():
    """The serving path's modules load in a process where ``jax`` and
    ``repro`` cannot, and load neither, nor an optimiser of the port."""
    code = (
        "import sys\n"
        "for m in ('jax', 'repro', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {MODEL_STACK!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and (m in ('jax', 'repro', 'msgpack')\n"
        "                  or m.startswith(('jax.', 'repro.', 'msgpack.'))\n"
        "                  or m.startswith('repro_torch.optim')))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n"
        f"need = {MODEL_STACK!r}\n"
        "print('IMPORTED', [m for m in need if m in sys.modules])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(SRC.parent)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    assert f"IMPORTED {list(MODEL_STACK)!r}" in res.stdout


def test_the_model_stack_serves_with_jax_blocked():
    """A reduced config through ``run_serving`` on the CPU, with ``jax``
    and ``repro`` blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.launch.serve import run_serving\n"
        "out, _ = run_serving(arch='granite-moe-1b-a400m', batch=2,\n"
        "                     prompt_len=8, new_tokens=3, device='cpu')\n"
        "print('SHAPE', tuple(out.shape))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(SRC.parent)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "SHAPE (2, 3)" in res.stdout
