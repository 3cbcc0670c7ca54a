"""Launch in the port: meshes, the mesh steps, the dry run and its
roofline, and the ``serve`` and ``train`` launchers."""
from .mesh import make_host_mesh, make_lane_mesh, make_production_mesh
from .shapes import INPUT_SHAPES, InputShape, config_for_shape, input_specs

__all__ = [k for k in dir() if not k.startswith("_")]
