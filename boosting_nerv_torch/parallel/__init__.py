"""The mesh of the port (counterpart of boosting_nerv_tpu/parallel/): its
'data' and 'spatial' axes over torch process groups (``mesh``), the
forward split by rows over the 'spatial' axis (``spatial``) and the
process a rank that runs them (``launch``)."""

from .launch import launch
from .mesh import MeshPlan, make_mesh_plan

__all__ = ["MeshPlan", "launch", "make_mesh_plan"]
