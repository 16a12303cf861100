"""Kernel names by kind, as the port's `tools/profile_torch_train.py`
sorts a profiler's device events (a frozen copy of its regexes)."""

import re

GEMM = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|sm90_", re.I)
# cuBLAS f32 GEMMs (FP32 cores): the logits products of the chunked loss
F32_GEMM = re.compile(r"f32f32|sgemm|ffma|_sss", re.I)
# the port's hand-written kernels: name fragment -> kernel
FLASH = (("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
         ("flash_bwd_dq_kernel", "flash_bwd_dq"),
         ("flash_fwd_kernel", "flash_fwd"),
         ("roi_align_", "roi_align"))
CONV = re.compile(r"fprop|dgrad|wgrad|conv|implicit", re.I)
REDUCE = re.compile(r"reduce_kernel|welford", re.I)
INDEX = re.compile(r"index|scatter|gather", re.I)


def kind(name: str) -> str:
    for marker, k in FLASH:
        if marker in name:
            return k
    if CONV.search(name):
        return "conv"
    if REDUCE.search(name):
        return "reduce"
    if INDEX.search(name):
        return "index"
    if GEMM.search(name):
        return "matmul_f32" if F32_GEMM.search(name) else "matmul_bf16"
    return "other"
