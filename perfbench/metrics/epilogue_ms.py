"""Stream ms a pass in the datapath's f32 epilogue (``datapath.epilogue``:
``kernels/ops._finish``, ``backend.dequant_sums``), self time."""
from perfbench.recording import self_ms


def read(ctx):
    return self_ms(ctx, "datapath.epilogue")
