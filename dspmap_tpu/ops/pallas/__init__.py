"""Pallas kernels for the GPU (Triton route), each matching an XLA
formulation element for element: the occupancy/resample pool pass."""
