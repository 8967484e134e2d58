from ptsharp.accel import bvh, traverse

__all__ = ["bvh", "traverse"]
