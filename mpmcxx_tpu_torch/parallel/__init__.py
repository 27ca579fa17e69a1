"""Replica chains, parallel tempering and the mesh of devices.

JAX twin: mpmcxx_tpu/parallel/ (replicas.py, driver.py, meshing.py,
sharded_energy.py).
"""
