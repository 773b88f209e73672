from .planning_task import CollisionResiduals, PlanningTask

__all__ = ["PlanningTask", "CollisionResiduals"]
