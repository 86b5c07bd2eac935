"""Hand-written CUDA kernels of the port (``repro.kernels`` counterpart).

Sources live in ``csrc/`` and are compiled with ``nvcc`` at first use
(``kernels.build``); importing this package compiles nothing.
"""
