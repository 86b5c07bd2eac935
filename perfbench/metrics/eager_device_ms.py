"""Device time a pass in the work around the port's own CUDA kernels:
calibration, quantization, the epilogue, BN and pooling, norms, routing,
dispatch and combine, attention and the unembedding (PyTorch's kernels,
memsets and copies)."""

#: the port's hand-written kernels (``src/repro_torch/kernels/csrc``)
PORT_KERNELS = ("quant8_kernel", "fused_kernel", "stream_kernel",
                "mma_kernel", "bitsim_kernel", "probe_kernel")


def read(ctx):
    t = ctx.trace
    if not t.kernels:
        return None
    eager = sum(k.seconds for k in t.kernels
                if not any(p in k.name for p in PORT_KERNELS))
    return 1e3 * eager / t.passes
