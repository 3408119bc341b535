from .atlas import Atlas, get_map, apply_map

__all__ = ["Atlas", "get_map", "apply_map"]
