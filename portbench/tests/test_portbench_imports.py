"""What a run loads, reads and writes: no module of JAX, flax or the JAX
package (top-level names compared whole), no file under ``benchmarks/``,
nothing in ``/dev/shm``, writes only inside the checkout, ``HOME``,
``XDG_CACHE_HOME`` and ``TMPDIR``. A reduced cell runs end to end on the
CPU in a child process that records every file it opens. Each module of
the plain reference, imported alone in a child process, loads nothing of
the program (``repro_torch``) and nothing of JAX or the JAX package."""

import json
import os
import subprocess
import sys

import pytest

import pbtest

from portbench import run

CHILD = r"""
import json, os, sys
opened = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        path = os.path.abspath(os.fsdecode(args[0]))
        mode = args[1] if isinstance(args[1], str) else ""
        flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
        write = any(c in mode for c in "wax+") or bool(flags & (os.O_WRONLY | os.O_RDWR))
        opened.append((path, write))
sys.addaudithook(hook)
sys.path[:0] = [sys.argv[1]]
import pytest

import pbtest
import torch
from portbench import check, run
for name in pbtest.CASES:
    cell = pbtest.smoke_cell(name)
    rec, _, checks = run.execute(cell, 11, 1.0, False, torch.device("cpu"))
    assert check.passed(checks), checks
print(json.dumps({"banned": run.banned_modules(), "opened": opened,
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


REFERENCES = sorted(p.stem for p in (pbtest.ROOT / "portbench" / "reference").glob("*.py")
                    if p.stem != "__init__")


@pytest.mark.parametrize("name", REFERENCES)
def test_a_reference_module_loads_nothing_of_the_program(name):
    code = ("import importlib, json, sys; sys.path[:0] = [sys.argv[1]]; "
            f"importlib.import_module('portbench.reference.{name}'); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-B", "-c", code, str(pbtest.ROOT)],
                         capture_output=True, text=True, timeout=300, cwd=str(pbtest.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & (set(run.BANNED) | {"repro_torch"}), loaded


def test_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.BANNED:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.banned_modules() == ["jax", "repro"]


def test_a_run_loads_no_jax_and_touches_only_its_own_files(tmp_path):
    env = dict(os.environ, HOME=str(tmp_path / "home"), TMPDIR=str(tmp_path / "tmp"),
               XDG_CACHE_HOME=str(tmp_path / "cache"))
    for d in ("home", "tmp", "cache"):
        (tmp_path / d).mkdir()
    tests = str(pbtest.ROOT / "portbench" / "tests")
    out = subprocess.run([sys.executable, "-B", "-c", CHILD, tests], capture_output=True,
                         text=True, env=env, timeout=600, cwd=str(pbtest.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["banned"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])
    root = str(pbtest.ROOT)
    allowed = (root, str(tmp_path), "/dev/null")
    for path, write in got["opened"]:
        assert not path.startswith(os.path.join(root, "benchmarks") + os.sep), path
        assert not path.startswith("/dev/shm"), path
        if write:
            assert path.startswith(allowed), path
