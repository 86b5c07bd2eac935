"""Stream ms a pass in the bank's packing and its move to the device:
``bank.pack`` (``layers.bank_backend``: the tables through
``lut_to_uint16`` on the host) and ``bank.upload``
(``MaterializedBackend.device_consts`` on a miss), self time."""
from perfbench.recording import self_ms


def read(ctx):
    return self_ms(ctx, "bank.pack", "bank.upload")
