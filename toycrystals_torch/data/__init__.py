"""Data of the port: lattice geometry, the rasterizer kernel, dataset sources."""
