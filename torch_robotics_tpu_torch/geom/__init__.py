from .point_cloud import PointCloudSpheres
from .sdf import (MultiBoxField, MultiSharpBoxField, MultiSphereField,
                  ObjectField, RoundedBoxes, SharpBoxes, Spheres)

__all__ = ["Spheres", "SharpBoxes", "RoundedBoxes", "ObjectField",
           "MultiSphereField", "MultiSharpBoxField", "MultiBoxField",
           "PointCloudSpheres"]
