from .base import EnvBase
from .zoo import EnvMazeBoxes3D, EnvSpheres3D, make_env

__all__ = ["EnvBase", "EnvMazeBoxes3D", "EnvSpheres3D", "make_env"]
