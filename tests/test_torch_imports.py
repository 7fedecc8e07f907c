"""The PyTorch port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py`` and no script under ``tools/`` imports JAX or the JAX
package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_files():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_mesh_module_is_covered_and_starts_nothing_on_import():
    """``launch/mesh.py`` is among the files checked above, and importing
    it joins no process group and starts no process (the tests' workers
    and the spawned ranks import it)."""
    import multiprocessing
    import os
    import subprocess
    import sys
    assert ROOT / "src" / "repro_torch" / "launch" / "mesh.py" in FILES
    code = ("import multiprocessing, torch.distributed as dist; "
            "import repro_torch.launch.mesh; "
            "assert not dist.is_initialized(); "
            "assert not multiprocessing.active_children()")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={**os.environ,
                                       "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    assert not multiprocessing.active_children()
