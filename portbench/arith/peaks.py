"""Published peaks of the cards the benchmark runs on.

Dense bf16 tensor-core rates by `torch.cuda.get_device_name` (NVIDIA's data
sheets; copied from the port's `train/trainer.py` PEAK_FLOPS table) and the
HBM bandwidth of the H100 SXM part.  Rates assume the full power limit;
each result line carries the card's limit beside its shares.
"""

PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,    # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
}
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}
# the H100 SXM's, for arithmetic that names no card (the bounds below)
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12


def peak_flops(kind: str) -> float:
    return PEAK_BF16_FLOPS.get(kind, H100_BF16_FLOPS)


def peak_bytes(kind: str) -> float:
    return PEAK_BYTES_PER_S.get(kind, H100_BYTES_PER_S)
