"""Import guard for the port: ``src/repro_torch/`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro`` (``repro_torch``
is fine), and no kernel wrapper reaches its plain version from inside an
``except`` clause (no silent fallback from a failed launch)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", "")) in ("import_module", "__import__"):
            args = [a.value for a in node.args if isinstance(a, ast.Constant)]
            bad += [a for a in args if isinstance(a, str) and _forbidden(a)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_plain_fallback_in_except(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for handler in (n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)):
        for node in ast.walk(handler):
            name = getattr(node, "attr", getattr(node, "id", ""))
            assert not (isinstance(node, (ast.Name, ast.Attribute))
                        and name.endswith("_plain")), (
                f"{path.relative_to(REPO)}:{handler.lineno} calls a plain "
                f"version from an except clause")


FLEET = [REPO / "src" / "repro_torch" / "serving" / f"{m}.py"
         for m in ("transport", "host_main", "router", "api")]


@pytest.mark.parametrize("path", FLEET, ids=lambda p: p.name)
def test_fleet_excepts_never_change_the_route(path):
    """A transport error marks a host lost; no ``except`` of the fleet
    modules serves a request another way: none names the CPU or a device,
    or builds an engine or a fleet."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert path in FILES                  # the import guard covers it too
    for handler in (n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)):
        for node in ast.walk(handler):
            name = getattr(node, "attr", getattr(node, "id", ""))
            text = node.value if isinstance(node, ast.Constant) else None
            assert not (isinstance(text, str) and "cpu" in text.lower()), (
                f"{path.name}:{handler.lineno} names the CPU in an except clause")
            assert name not in ("device", "Engine", "build_inproc_fleet", "to", "cpu"), (
                f"{path.name}:{handler.lineno} changes the route in an except clause")


def test_guard_has_teeth():
    assert _forbidden("jax.numpy") and _forbidden("repro.models")
    assert _forbidden("repro") and not _forbidden("repro_torch.models")
    src = "try:\n    k()\nexcept RuntimeError:\n    qgemm_plain(a)\n"
    handler = next(n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.ExceptHandler))
    assert any(getattr(n, "id", "").endswith("_plain") for n in ast.walk(handler))
