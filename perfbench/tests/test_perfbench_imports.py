"""No module of the JAX package or of JAX in a run, compared by whole
top-level names; and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench import harness

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_whole_top_level_names():
    found = harness.forbidden_loaded(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "centernet_uda_tpu", "centernet_uda_tpu.ops.dcn",
         "centernet_uda_torch", "centernet_uda_torch.ops", "jaxtyping",
         "flaxen", "perfbench.jax_free"])
    assert found == ["centernet_uda_tpu", "centernet_uda_tpu.ops.dcn", "flax.linen",
                     "jax", "jax.numpy", "jaxlib.xla_client"]


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in PERFBENCH.rglob("*.py"):
        for name in imported(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in list((PERFBENCH / "reference").rglob("*.py")) + [
            PERFBENCH / "weights.py", PERFBENCH / "counts.py"]:
        for name in imported(path):
            assert name.split(".")[0] != "centernet_uda_torch", (path, name)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "torch.set_num_threads(2)\n"
        "from perfbench import harness\n"
        "r = harness.run_cell('dla34_baseline.eval_800', 5, 0.3, False,"
        " device='cpu', overrides=['dcn_impl=cuda'], mix_overrides="
        "{'input_size': 64, 'batch': 1, 'objects': [1, 2],"
        " 'box_px': [8, 16]}, emit=False)\n"
        "print(json.dumps([harness.forbidden_loaded(list(sys.modules)),"
        " 'centernet_uda_torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    found, loaded_program = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and loaded_program
