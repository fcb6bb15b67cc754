"""Utilities of the port: weight bridge, CUDA build."""
