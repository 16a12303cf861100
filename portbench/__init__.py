"""portbench: the benchmark of the PyTorch/CUDA port (`cloudtik_tpu_torch`).

`run.py` is the one command; see its docstring.  Everything that defines
the measurement (traffic generation, the reduction of traces and spans to
metrics, peaks, operation and byte counts, the float32 reference and the
comparison that decides `correct`) lives here, apart from the program.
"""
