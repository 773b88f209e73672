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


def test_prior_helpers_default_to_the_card(monkeypatch):
    """The GP prior's public block builders took device="cpu" by default,
    a quiet CPU run; they now default to the card like every entry point
    and raise without one."""
    from torch_robotics_tpu_torch.solve import gp_prior
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: gp_prior.gp_transition(2, 0.1, **kw),
                 lambda **kw: gp_prior.gp_Q_inv(2, 0.1, 0.5, **kw),
                 lambda **kw: gp_prior.gp_prior_blocks(2, 4, 0.1, 1e-3, 0.1,
                                                       1e-3, **kw)[0]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        assert make(device="cpu").device.type == "cpu"


def test_wrappers_take_the_kernel_or_raise_off_the_cpu():
    """CPU tensors take the plain versions; a tensor on any other device
    goes to the kernel path, which refuses what is not CUDA."""
    from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
    from torch_robotics_tpu_torch.ops.riccati_kernel import (
        linesearch_rollout_kernel_factory, riccati_backward_kernel_factory)
    from torch_robotics_tpu_torch.ops.terms_kernel import (run_cost_kernel,
                                                           run_terms_kernel)
    D = torch.zeros((2, 4, 4, 3), device="meta")
    U = torch.zeros((2, 4, 4, 1), device="meta")
    b = torch.zeros((2, 4, 3), device="meta")
    with pytest.raises(ValueError):
        solve_lanes_w(D, U, b)
    ints = torch.zeros(8, dtype=torch.int32, device="meta")
    floats = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        run_terms_kernel(torch.zeros((7, 5), device="meta"), ints, floats, 7,
                         dict(lanes=128, smem_bytes=0))
    with pytest.raises(ValueError):
        run_cost_kernel(torch.zeros((7, 5), device="meta"), ints, floats, 7)
    d, m, P, T, B = 7, 14, 27, 3, 5
    sweep = riccati_backward_kernel_factory(d, m, P, T, 0.04, 1e-6, 1e-6, 4e4)
    with pytest.raises(ValueError):
        sweep(*(torch.zeros(s, device="meta") for s in
                ((T, d, B), (T, m, B), (T, m, P, B), (m, B))))
    roll = linesearch_rollout_kernel_factory(d, m, T, 0.04, (1.0, 0.5))
    with pytest.raises(ValueError):
        roll(*(torch.zeros(s, device="meta") for s in
               ((T + 1, m, B), (T, d, B), (T, d, B), (T, d, m, B))))


def test_ilqr_solve_on_a_non_cuda_device_raises():
    """The default sweeps on a tensor that is neither CPU nor CUDA go to
    the kernel path, which refuses it: no quiet plain fallback."""
    from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve

    def residuals(q):
        return torch.tanh(q) * 0.1
    residuals.supports_batch = True
    x0 = torch.zeros((3, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ilqr_solve(residuals, x0, x0, ILQRParams(n_support_points=4,
                                                 opt_iters=1))


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


def test_multirobot_entry_points_default_to_the_card(monkeypatch):
    """The UR10, its model and the axis rotations of base poses default to
    the card and raise without one; a MultiRobot lives where its members
    do."""
    from torch_robotics_tpu_torch.core import x_rot, y_rot, z_rot
    from torch_robotics_tpu_torch.kin import robot_zoo
    from torch_robotics_tpu_torch.robots import MultiRobot, RobotUR10
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (RobotUR10, robot_zoo.ur10, lambda: z_rot(0.5),
                 lambda: x_rot(0.5), lambda: y_rot(0.5)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    robot = MultiRobot.create(
        [RobotUR10(device="cpu"), RobotUR10(device="cpu")],
        [(z_rot(0.0, device="cpu"), [0.0, 0.5, 0.0]),
         (z_rot(3.0, device="cpu"), [0.0, -0.5, 0.0])])
    assert robot.device.type == "cpu" and robot.base_rots.device.type == "cpu"


def test_multirobot_wrappers_take_the_kernel_or_raise_off_the_cpu():
    """The column sweep, the routing solve and the MultiRobot terms kernel
    refuse a tensor that is neither CPU nor CUDA: no quiet plain run."""
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        solve_lanes_auto, solve_lanes_cols)
    from torch_robotics_tpu_torch.ops.terms_kernel import \
        run_multirobot_terms_kernel
    for m in (4, 40):
        D = torch.zeros((2, m, m, 3), device="meta")
        U = torch.zeros((2, m, m, 1), device="meta")
        b = torch.zeros((2, m, 3), device="meta")
        for solve in (solve_lanes_cols, solve_lanes_auto):
            with pytest.raises(ValueError):
                solve(D, U, b)
    ints = torch.zeros(16, dtype=torch.int32, device="meta")
    floats = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        run_multirobot_terms_kernel(
            torch.zeros((20, 5), device="meta"), ints, floats, 20,
            dict(lanes=32, block_pairs=6, threads=192, smem_bytes=1024))


def test_point_mass_and_point_cloud_entry_points_default_to_the_card(
        monkeypatch):
    """The point mass, the 2-D scene, the point cloud and the exact prior
    sampler's matrices default to the card and raise without one; the
    sampler itself runs where its endpoints live."""
    from torch_robotics_tpu_torch.envs import EnvDense2D
    from torch_robotics_tpu_torch.geom import PointCloudSpheres
    from torch_robotics_tpu_torch.robots import (RobotPointMass,
                                                 RobotPointMass3D)
    from torch_robotics_tpu_torch.solve import gp_prior
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    centers = [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]]
    for make in (RobotPointMass.create, RobotPointMass3D, EnvDense2D,
                 lambda: PointCloudSpheres.create(centers),
                 lambda: gp_prior.gp_bridge_sampler_matrix(2, 4, 0.1, 0.5),
                 lambda: gp_prior.gp_bridge_mean_matrices(2, 4, 0.1, 0.5)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert RobotPointMass.create(device="cpu").device.type == "cpu"
    assert PointCloudSpheres.create(
        centers, device="cpu").centers.device.type == "cpu"
    s = torch.zeros(4)
    trajs = gp_prior.sample_gp_prior_trajs(torch.Generator(), s, s + 1.0, 4,
                                           3, 0.1, 0.5)
    assert trajs.shape == (3, 4, 4) and trajs.device.type == "cpu"


def test_reuse_and_sdf_wrappers_take_the_kernel_or_raise_off_the_cpu():
    """The factor-persisting sweep, the substitution sweep and the sphere
    SDF refuse a tensor that is neither CPU nor CUDA: no quiet plain run."""
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        solve_lanes_factor, solve_lanes_subst)
    from torch_robotics_tpu_torch.ops.sdf_kernel import sphere_sdf_kernel
    D = torch.zeros((2, 4, 4, 3), device="meta")
    U = torch.zeros((2, 4, 4, 1), device="meta")
    b = torch.zeros((2, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        solve_lanes_factor(D, U, b)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        solve_lanes_subst(D, D, b)
    with pytest.raises(ValueError):
        solve_lanes_subst(D, D[..., :2], b)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sphere_sdf_kernel(torch.zeros((5, 3), device="meta"),
                          torch.zeros((2, 3), device="meta"),
                          torch.zeros((2,), device="meta"))


def test_sampling_and_unrouted_kernel_modules_are_checked():
    """The sGPMP solver, the plain cyclic reduction and the GN assembly
    wrapper are among the sources the import checks above cover."""
    names = {str(p.relative_to(PORT)) for p in _port_sources()
             if PORT in p.parents}
    assert {"solve/sampling.py", "solve/btridiag_bcr.py",
            "ops/gn_assembly_kernel.py"} <= names


def test_sgpmp_and_new_wrappers_take_the_kernel_or_raise_off_the_cpu(
        monkeypatch):
    """sGPMP on CPU tensors scores through the plain cost (no launch); on a
    tensor that is neither CPU nor CUDA the cost kernel's wrapper refuses
    it, as do the L-and-y sweep, the cyclic reduction, the GN assembly and
    the MultiRobot cost kernel; the default task needs the card."""
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.ops import terms_kernel
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        solve_lanes_cr, solve_lanes_sweep)
    from torch_robotics_tpu_torch.ops.gn_assembly_kernel import gn_assembly
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import (SGPMPParams, sgpmp_solve,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=RobotPanda.create(device="cpu"))
    s = torch.zeros((2, 14))
    g = torch.full((2, 14), 0.3)
    g[:, 7:] = 0.0
    theta0 = straight_line_trajs(s, g, 4)
    p = SGPMPParams(n_support_points=4, opt_iters=1, num_samples=3)
    n0 = terms_kernel.COST_KERNEL.launches
    res = sgpmp_solve(task.collision_residuals, theta0, s, g, p,
                      generator=torch.Generator().manual_seed(0))
    assert res.trajs.shape == (2, 4, 14) and res.cost_trace.shape == (1, 2)
    assert terms_kernel.COST_KERNEL.launches == n0
    with pytest.raises(ValueError, match="CUDA tensors"):
        sgpmp_solve(task.collision_residuals, theta0.to("meta"),
                    s.to("meta"), g.to("meta"), p,
                    generator=torch.Generator().manual_seed(0))
    D = torch.zeros((2, 4, 4, 3), device="meta")
    U = torch.zeros((2, 4, 4, 1), device="meta")
    b = torch.zeros((2, 4, 3), device="meta")
    for solve in (solve_lanes_sweep, solve_lanes_cr):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            solve(D, U, b)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gn_assembly(torch.zeros((3, 5), device="meta"),
                    torch.zeros((3, 2, 5), device="meta"))
    ints = torch.zeros(16, dtype=torch.int32, device="meta")
    floats = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        terms_kernel.run_multirobot_cost_kernel(
            torch.zeros((20, 5), device="meta"), ints, floats, 20, 6, 1024)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlanningTask(env=EnvSpheres3D(), robot=RobotPanda.create())
