from .grid_sdf import GridSDF, precompute_sdf_grid
from .objects import GraspedObject, GraspedObjectPandaBox
from .occupancy import OccupancyMap, build_occupancy_map
from .point_cloud import PointCloudSpheres
from .sdf import (MultiBoxField, MultiSharpBoxField, MultiSphereField,
                  ObjectField, RoundedBoxes, SharpBoxes, Spheres)

__all__ = ["Spheres", "SharpBoxes", "RoundedBoxes", "ObjectField",
           "MultiSphereField", "MultiSharpBoxField", "MultiBoxField",
           "PointCloudSpheres", "GridSDF", "precompute_sdf_grid",
           "OccupancyMap", "build_occupancy_map", "GraspedObject",
           "GraspedObjectPandaBox"]
