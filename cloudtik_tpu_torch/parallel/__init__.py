"""The parallel layer over `torch.distributed`: process bring-up
(distributed.py), the named-axis device mesh (mesh.py), the logical-axis
rules and the ambient mesh (sharding.py), and the collectives with the
gradients the trainer and the model code need (collectives.py)."""
