from .btridiag_bcr import block_tridiag_solve_bcr, solve_lanes_bcr
from .gp_prior import (gp_prior_terms, sample_gp_prior_trajs,
                       straight_line_trajs)
from .gpmp2 import (GPMP2Params, GPMP2Result, gpmp2_init_trajs, gpmp2_solve,
                    gpmp2_solve_adaptive, gpmp2_solve_restarts, gpmp2_step)
from .ilqr import ILQRParams, ILQRResult, ilqr_solve
from .mpc import MPCParams, MPCState, mpc_init, mpc_rollout, mpc_step
from .riccati_lanes import linesearch_rollout_lanes, riccati_backward_lanes
from .sampling import (SGPMPParams, SGPMPResult, sgpmp_solve,
                       sgpmp_solve_normals)

__all__ = ["GPMP2Params", "GPMP2Result", "gpmp2_init_trajs", "gpmp2_solve",
           "gpmp2_solve_adaptive", "gpmp2_solve_restarts", "gpmp2_step",
           "gp_prior_terms", "sample_gp_prior_trajs", "straight_line_trajs",
           "MPCParams", "MPCState", "mpc_init", "mpc_step", "mpc_rollout",
           "ILQRParams", "ILQRResult", "ilqr_solve",
           "riccati_backward_lanes", "linesearch_rollout_lanes",
           "SGPMPParams", "SGPMPResult", "sgpmp_solve", "sgpmp_solve_normals",
           "solve_lanes_bcr", "block_tridiag_solve_bcr"]
