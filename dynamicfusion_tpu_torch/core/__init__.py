"""Geometry math on tensors: SE(3) transforms, pinhole camera, dual quaternions."""
