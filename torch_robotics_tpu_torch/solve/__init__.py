from .btridiag import (block_tridiag_cholesky, block_tridiag_logdet,
                       block_tridiag_solve, block_tridiag_solve_factored)
from .btridiag_bcr import block_tridiag_solve_bcr, solve_lanes_bcr
from .btridiag_lanes import block_tridiag_solve_lanes
from .chomp import CHOMPParams, CHOMPResult, chomp_solve
from .ee_goal import make_ee_goal_terms
from .gp_prior import (gp_prior_terms, sample_gp_prior_trajs,
                       straight_line_trajs)
from .gpmp2 import (GPMP2Params, GPMP2Result, gpmp2_init_trajs, gpmp2_solve,
                    gpmp2_solve_adaptive, gpmp2_solve_restarts, gpmp2_step)
from .hybrid import plan_hybrid, plan_mpot_gpmp2
from .ilqr import ILQRParams, ILQRResult, ilqr_solve
from .mpc import MPCParams, MPCState, mpc_init, mpc_rollout, mpc_step
from .mpot import MPOTParams, MPOTResult, mpot_solve, polytope_vertices
from .riccati_lanes import linesearch_rollout_lanes, riccati_backward_lanes
from .rrt import RRTConnectParams, rrt_connect
from .sampling import (SGPMPParams, SGPMPResult, sgpmp_solve,
                       sgpmp_solve_normals)

__all__ = ["GPMP2Params", "GPMP2Result", "gpmp2_init_trajs", "gpmp2_solve",
           "gpmp2_solve_adaptive", "gpmp2_solve_restarts", "gpmp2_step",
           "gp_prior_terms", "sample_gp_prior_trajs", "straight_line_trajs",
           "MPCParams", "MPCState", "mpc_init", "mpc_step", "mpc_rollout",
           "ILQRParams", "ILQRResult", "ilqr_solve",
           "riccati_backward_lanes", "linesearch_rollout_lanes",
           "SGPMPParams", "SGPMPResult", "sgpmp_solve", "sgpmp_solve_normals",
           "solve_lanes_bcr", "block_tridiag_solve_bcr",
           "make_ee_goal_terms", "block_tridiag_cholesky",
           "block_tridiag_solve_factored", "block_tridiag_solve",
           "block_tridiag_logdet", "block_tridiag_solve_lanes",
           "CHOMPParams", "CHOMPResult", "chomp_solve", "RRTConnectParams",
           "rrt_connect", "plan_hybrid", "plan_mpot_gpmp2", "MPOTParams",
           "MPOTResult", "mpot_solve", "polytope_vertices"]
