from .losses import flatten_levels

__all__ = ["flatten_levels"]
