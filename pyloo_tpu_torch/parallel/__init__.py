"""Row-parallel execution of the per-observation scorers over a device mesh."""

from .sharding import Mesh, apply_rowwise, obs_mesh

__all__ = ["Mesh", "obs_mesh", "apply_rowwise"]
