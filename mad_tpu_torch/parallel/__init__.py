"""Capacity mode of the port: meshes of devices and x-sharded volumes
(port of mad_tpu/parallel/mesh.py and mad_tpu/parallel/volume.py)."""
