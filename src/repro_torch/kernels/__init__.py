"""Hopper kernels of the port, their launch wrappers and plain versions."""
