"""Host and tensor utilities of the port (ref: mayamatchmovesolver_tpu/utils)."""
