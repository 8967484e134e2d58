from ptsharp.core import vec, sampling, color, transform

__all__ = ["vec", "sampling", "color", "transform"]
