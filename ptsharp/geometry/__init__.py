from ptsharp.geometry import primitives, sdf, volume

__all__ = ["primitives", "sdf", "volume"]
