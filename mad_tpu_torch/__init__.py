"""mad_tpu_torch -- PyTorch + CUDA port of mad_tpu."""
