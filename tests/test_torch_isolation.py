"""The port stands alone: ``centernet_uda_torch`` and ``chip_smoke.py``
import neither JAX (nor flax / optax) nor anything of ``centernet_uda_tpu``,
and run their imports with those packages blocked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "centernet_uda_tpu")
PORT_FILES = sorted((ROOT / "centernet_uda_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_imports_with_jax_blocked():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in PORT_FILES]
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = "\n".join([
        "import sys",
        f"for name in {FORBIDDEN!r}:",
        "    sys.modules[name] = None",
        "import importlib",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        f"assert not any(sys.modules.get(n) for n in {FORBIDDEN!r})",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA card, and alone in a directory without the package,
    chip_smoke.py exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
