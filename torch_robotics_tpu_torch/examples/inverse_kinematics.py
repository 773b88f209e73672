"""Batched Adam IK for the Panda to a target SE(3) pose, and the valid
solutions' skeletons (counterpart of examples/inverse_kinematics.py; its
3-D plot waits for the port of ``viz/``).

    python -m torch_robotics_tpu_torch.examples.inverse_kinematics
    python torch_robotics_tpu_torch/examples/inverse_kinematics.py \\
        [--device cpu] [--batch-size 10] [--max-iters 500]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from torch_robotics_tpu_torch.core import (TimerCUDA,  # noqa: E402
                                           fix_random_seed, pack_homogeneous,
                                           y_rot, z_rot)
from torch_robotics_tpu_torch.kin import (  # noqa: E402
    get_skeleton_from_model, inverse_kinematics, robot_zoo)


def main(device: str = "cuda", batch_size: int = 10,
         max_iters: int = 500):
    gen = fix_random_seed(0, device=device)
    pos_target = torch.tensor([0.2, 0.4, 0.1], device=gen.device)
    rot_target = (z_rot(torch.tensor(-math.pi / 2), device=device)
                  @ y_rot(torch.tensor(-math.pi), device=device))
    H_target = pack_homogeneous(rot_target, pos_target)

    print("=================== Panda IK ===================")
    panda = robot_zoo.franka_panda(device=device)
    with TimerCUDA(device=device) as t:
        res = inverse_kinematics(
            panda, H_target, link_name="ee_link", batch_size=batch_size,
            max_iters=max_iters, lr=2e-1, se3_eps=5e-2,
            eps_joint_lim=math.pi / 64, generator=gen, device=device)
        t.block_on(res.q)
    valid = res.valid.cpu()
    print(f"IK time: {t.elapsed:.3f}s")
    print(f"valid: {int(valid.sum())}/{batch_size}")
    print(f"SE3 error (valid): {res.err_se3.cpu()[valid].numpy()}")
    skeletons = [get_skeleton_from_model(panda, res.q[i])
                 for i in range(batch_size) if bool(valid[i])]
    for sk in skeletons[:3]:
        print("ee_link at", sk.positions[panda.link_index("ee_link")])
    return res, skeletons


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--max-iters", type=int, default=500)
    args = ap.parse_args()
    main(args.device, args.batch_size, args.max_iters)
