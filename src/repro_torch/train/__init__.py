"""Training (port of ``repro.train``): AdamW with its schedule and
clipping, int8 gradient compression with error feedback, the
checkpoint manager and the fault-tolerant training loop."""
