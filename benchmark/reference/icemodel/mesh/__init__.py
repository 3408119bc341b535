from .mesh_types import Mesh
from .creation import build_mesh_from_config, build_uniform_mesh

__all__ = ["Mesh", "build_mesh_from_config", "build_uniform_mesh"]
