"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
no quiet move to the CPU when CUDA is missing."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "torch_robotics_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "torch_robotics_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, "%s imports %s" % (path, bad)


def test_port_imports_without_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import torch_robotics_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'torch_robotics_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_construction_without_cuda_raises(monkeypatch):
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RobotPanda.create()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnvSpheres3D()
    # the CPU runs only when asked for
    assert RobotPanda.create(device="cpu").device.type == "cpu"


def test_wrappers_take_the_kernel_or_raise_off_the_cpu():
    """CPU tensors take the plain versions; a tensor on any other device
    goes to the kernel path, which refuses what is not CUDA."""
    from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
    from torch_robotics_tpu_torch.ops.terms_kernel import run_terms_kernel
    D = torch.zeros((2, 4, 4, 3), device="meta")
    U = torch.zeros((2, 4, 4, 1), device="meta")
    b = torch.zeros((2, 4, 3), device="meta")
    with pytest.raises(ValueError):
        solve_lanes_w(D, U, b)
    ints = torch.zeros(8, dtype=torch.int32, device="meta")
    floats = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        run_terms_kernel(torch.zeros((7, 5), device="meta"), ints, floats, 7)


def test_chip_smoke_refuses_without_cuda():
    """Without a card the script exits nonzero and prints no result."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch, runpy, sys\n"
         "torch.cuda.is_available = lambda: False\n"
         "sys.argv = ['chip_smoke.py']\n"
         "runpy.run_path('chip_smoke.py', run_name='__main__')\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
