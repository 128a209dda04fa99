"""Data parallelism of the port (counterpart of boosting_nerv_tpu/parallel/):
the mesh plan's 'data' axis over a torch process group (``mesh``) and the
process a rank that runs it (``launch``)."""

from .launch import launch
from .mesh import MeshPlan, make_mesh_plan

__all__ = ["MeshPlan", "launch", "make_mesh_plan"]
