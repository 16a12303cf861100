"""Training recipes of the port: the counterparts of the JAX package's
`examples/recipes/` scripts, run as `python -m
cloudtik_tpu_torch.recipes.<name>`."""
