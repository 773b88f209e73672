from .base import EnvBase
from .zoo import EnvDense2D, EnvMazeBoxes3D, EnvSpheres3D, make_env

__all__ = ["EnvBase", "EnvDense2D", "EnvMazeBoxes3D", "EnvSpheres3D",
           "make_env"]
