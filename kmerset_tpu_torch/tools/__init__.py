"""Measurement tools for the port, run as modules on a CUDA machine."""
