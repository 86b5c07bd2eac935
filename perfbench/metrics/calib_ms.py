"""Stream ms a pass in the datapath's calibration (``datapath.calibrate``:
min/max and the quantization scalars, and on the two-step datapaths the
quantization), self time."""
from perfbench.recording import self_ms


def read(ctx):
    return self_ms(ctx, "datapath.calibrate")
