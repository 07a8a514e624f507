"""Stage profiling and the stage sanitizer (ports of mad_tpu/utils)."""
