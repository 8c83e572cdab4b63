"""The port stands alone: importing ``repro_torch`` (every submodule) loads
neither jax nor any module of the JAX package, and no source file of the
port or ``chip_smoke.py`` imports them."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _torch_threads import ONE_THREAD_ENV  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "triton")


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **ONE_THREAD_ENV)
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("launch.serve", "launch.train", "optim.adamw", "ckpt.checkpoint"):
        assert f"repro_torch.{name}" in got["modules"]
    for name in ("flash_attention", "rglru_scan", "wkv6"):
        assert f"repro_torch.kernels.{name}" in got["modules"]
    assert "repro_torch.models.rwkv6" in got["modules"]
    assert "repro_torch.models.rglru" in got["modules"]
    assert [m for m in got["loaded"] if _foreign(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [name for name in _imports(path) if _foreign(name)]
    assert bad == [], f"{path.name} imports {bad}"
