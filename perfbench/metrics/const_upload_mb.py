"""MB (10^6 bytes) a pass of constants moved to the device by
``bank.upload`` (counter ``bytes_to_device``)."""
from perfbench.recording import counter


def read(ctx):
    n = counter(ctx, "bytes_to_device")
    return None if n is None else n / 1e6
