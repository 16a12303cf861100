"""cloudtik_tpu_torch — the PyTorch/CUDA port of cloudtik_tpu's device side.

Each module sits at the same relative path as its JAX counterpart in
`cloudtik_tpu/` (`cloudtik_tpu/models/transformer.py` ->
`cloudtik_tpu_torch/models/transformer.py`) and keeps its public names, so
the two are easy to hold side by side.  The JAX package stays the reference;
this package imports `torch` and never `jax` or anything of `cloudtik_tpu`.

Every Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper (`csrc/`), built with `nvcc` at its first launch on a CUDA tensor
(`ops/_kernels.py`).  Importing this package needs neither CUDA, `nvcc` nor
`triton`: entry points run on the card (`device=None` means "cuda") and run
on the CPU only when the caller asks for it, as the tests do.
"""
