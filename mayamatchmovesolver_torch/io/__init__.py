"""File formats of the port (ref: mayamatchmovesolver_tpu/io); so far the
Nuke-script lens file."""
