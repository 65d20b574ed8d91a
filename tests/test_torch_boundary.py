"""The port stands without JAX: no module of composablestatespacemodels_torch
(nor chip_smoke.py, which drives it on the card) imports jax or the JAX
package, and the package imports with jax made unimportable."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "composablestatespacemodels_torch").rglob("*.py")
                    ) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "composablestatespacemodels_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_unavailable():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['composablestatespacemodels_tpu'] = None; "
            "import composablestatespacemodels_torch as ct; "
            "import composablestatespacemodels_torch.ops.resample_kernel; "
            "import composablestatespacemodels_torch.ops.scan_kernel; "
            "import composablestatespacemodels_torch.inference.interpolation; "
            "import composablestatespacemodels_torch.inference.lgcp; "
            "print(ct.log_likelihood.__name__)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "log_likelihood"


def test_kernel_sources_present():
    csrc = ROOT / "composablestatespacemodels_torch" / "csrc"
    for name in ("counts.cu", "resample_propagate.cu", "philox.cuh",
                 "obs_density.cuh"):
        assert (csrc / name).is_file(), name
