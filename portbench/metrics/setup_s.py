"""setup_s: process start to the window's first timed operation (host
clock): loading, drawing the weights, building or loading the kernels,
the first steps or the warm requests."""


def read(record):
    return record.get("setup_s")
