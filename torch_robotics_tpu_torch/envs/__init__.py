from .base import EnvBase
from .zoo import (EnvCircle2D, EnvDense2D, EnvDense2DExtraObjects,
                  EnvGridCircles2D, EnvMazeBoxes3D, EnvNarrowPassageDense2D,
                  EnvNarrowPassageDense2DExtraObjects, EnvPlanar2Link,
                  EnvSimple2D, EnvSimple2DExtraObjects, EnvSpheres3D,
                  EnvSpheres3DExtraObjects, EnvSquare2D, EnvTableShelf,
                  available_envs, make_env)

__all__ = ["EnvBase", "EnvCircle2D", "EnvDense2D", "EnvDense2DExtraObjects",
           "EnvGridCircles2D", "EnvMazeBoxes3D", "EnvNarrowPassageDense2D",
           "EnvNarrowPassageDense2DExtraObjects", "EnvPlanar2Link",
           "EnvSimple2D", "EnvSimple2DExtraObjects", "EnvSpheres3D",
           "EnvSpheres3DExtraObjects", "EnvSquare2D", "EnvTableShelf",
           "available_envs", "make_env"]
