"""Row-parallel execution of the per-observation scorers."""

from .sharding import apply_rowwise

__all__ = ["apply_rowwise"]
