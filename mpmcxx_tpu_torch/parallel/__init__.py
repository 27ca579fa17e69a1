"""Replica chains and parallel tempering on one device.

JAX twin: mpmcxx_tpu/parallel/ (replicas.py, driver.py; the mesh and the
sharded energy are not ported).
"""
