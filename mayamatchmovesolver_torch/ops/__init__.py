from mayamatchmovesolver_torch.ops import stmap  # noqa: F401  (module)
