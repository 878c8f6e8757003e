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


def test_the_graph_helper_is_checked():
    """``utils/graphs.py`` (the compiled steps) is among the checked
    files: it imports neither JAX nor the JAX package."""
    path = ROOT / "centernet_uda_torch" / "utils" / "graphs.py"
    assert path in PORT_FILES
    assert "torch" in _imported_roots(path)


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


def test_cli_and_data_need_no_image_or_logging_library(tmp_path):
    """With OpenCV, PIL, tensorboardX, tensorboard and JAX blocked, the
    CLI, the data pipeline, the evaluator and the checkpoints import; a
    dataset of PPM images at the input size, without augmentation, gives
    samples (reading and resizing any other image needs OpenCV), and the
    TensorBoard logger has no writer."""
    code = "\n".join([
        "import sys",
        "for name in " + repr(FORBIDDEN + ("cv2", "PIL", "tensorboardX",
                                           "tensorboard")) + ":",
        "    sys.modules[name] = None",
        "import json",
        "import numpy as np",
        "import centernet_uda_torch.train",
        "import centernet_uda_torch.evaluation",
        "import centernet_uda_torch.utils.checkpoint",
        "from centernet_uda_torch import data",
        "from centernet_uda_torch.data.coco import write_ppm",
        "from centernet_uda_torch.utils.tensorboard import TensorboardLogger",
        f"root = {str(tmp_path)!r}",
        "rng = np.random.RandomState(0)",
        "write_ppm(root + '/a.ppm', rng.randint(0, 256, (64, 64, 3), np.uint8))",
        "json.dump({'images': [{'id': 1, 'file_name': 'a.ppm'}],",
        "           'annotations': [{'id': 1, 'image_id': 1, 'category_id': 2,",
        "                            'bbox': [4, 6, 20, 16], 'area': 320}],",
        "           'categories': [{'id': 1}, {'id': 2}]},",
        "          open(root + '/a.json', 'w'))",
        "ds = data.build('coco', image_folder=root, annotation_file=root +",
        "                '/a.json', input_size=[64, 64], num_classes=2,",
        "                max_detections=4, augmentation=None)",
        "s = ds[0]",
        "assert s['input'].shape == (3, 64, 64) and s['hm'].shape == (2, 16, 16)",
        "assert s['reg_mask'].tolist() == [1, 0, 0, 0]",
        "assert TensorboardLogger(None).writer is None",
        f"assert not any(sys.modules.get(n) for n in {FORBIDDEN!r})",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
