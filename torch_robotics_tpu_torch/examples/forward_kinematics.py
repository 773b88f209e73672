"""Batched FK across the robot zoo, timed with TimerCUDA (counterpart of
examples/forward_kinematics.py).

    python -m torch_robotics_tpu_torch.examples.forward_kinematics
    python torch_robotics_tpu_torch/examples/forward_kinematics.py \\
        [--device cpu] [--batch-size 10]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from torch_robotics_tpu_torch.core import (TimerCUDA,  # noqa: E402
                                           fix_random_seed)
from torch_robotics_tpu_torch.kin import fk_all_links, robot_zoo  # noqa: E402

ZOO = {
    "Panda": robot_zoo.franka_panda,
    "UR10": robot_zoo.ur10,
    "Habitat Stretch": robot_zoo.habitat_stretch,
    "Tiago": robot_zoo.tiago_dual_holo_move,
    "Shadow Hand": robot_zoo.shadow_hand,
    "Allegro Hand": robot_zoo.allegro_hand,
    "KUKA iiwa7": robot_zoo.kuka_iiwa7,
}


def main(device: str = "cuda", batch_size: int = 10) -> dict:
    gen = fix_random_seed(1, device=device)
    out = {}
    for name, ctor in ZOO.items():
        print(f"\n==================== {name} ====================")
        model = ctor(device=device)
        print("links:", len(model.link_names), "dofs:", model.n_dofs)
        q = torch.rand((batch_size, model.n_dofs), generator=gen,
                       device=gen.device)
        fk_all_links(model, q)                       # warm-up
        with TimerCUDA(device=device) as t:
            data = fk_all_links(model, q)
            t.block_on(data)
        print(f"link tensor {tuple(data.shape)}, computational time "
              f"{t.elapsed:.6f}s")
        out[name] = data
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-size", type=int, default=10)
    args = ap.parse_args()
    main(args.device, args.batch_size)
