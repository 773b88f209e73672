from .gp_prior import gp_prior_terms, straight_line_trajs
from .gpmp2 import GPMP2Params, gpmp2_step
from .mpc import MPCParams, MPCState, mpc_init, mpc_step

__all__ = ["GPMP2Params", "gpmp2_step", "gp_prior_terms",
           "straight_line_trajs", "MPCParams", "MPCState", "mpc_init",
           "mpc_step"]
