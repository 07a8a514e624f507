"""The port's meshes: device meshes, x-sharded volumes (capacity mode) and
the multi-device step (port of mad_tpu/parallel/mesh.py, volume.py and
step.py); the sharded dock lives in the engine modules' ``mesh=`` paths."""
