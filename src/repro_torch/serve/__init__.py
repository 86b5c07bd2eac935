"""Serving layer (port of ``repro.serve``): the static-batch ``Engine``.
The continuous-batching stack (``ContinuousEngine``, ``scheduler``,
``kv_cache``) is ROADMAP.md Queue 1 item 7."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
