"""The parallel layer over `torch.distributed`: process bring-up
(distributed.py), the named-axis device mesh (mesh.py), the logical-axis
rules and the ambient mesh (sharding.py), the collectives with the
gradients the trainer and the model code need (collectives.py), FSDP's
gather-on-use (fsdp.py), the pipeline schedules (pipeline.py), the
overlapped gradient sync (overlap.py) and the local rank launcher
(launch.py)."""
