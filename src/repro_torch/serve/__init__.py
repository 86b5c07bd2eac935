"""Serving layer (port of ``repro.serve``): the static-batch ``Engine``.
The continuous-batching stack (``ContinuousEngine``, ``scheduler``,
``kv_cache``) is ROADMAP.md Queue 1, "Continuous-batching serving"."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
