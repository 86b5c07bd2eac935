"""Serving layer (port of ``repro.serve``): the static-batch ``Engine``
and the continuous-batching multi-tenant stack (``ContinuousEngine`` +
``Scheduler`` + ``PagedKVCache``; DESIGN.md §2.8)."""
from .engine import ContinuousEngine, Engine, ServeConfig
from .kv_cache import CacheLayout, PagedKVCache, cache_layout
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ContinuousEngine", "Engine", "ServeConfig", "CacheLayout",
           "PagedKVCache", "cache_layout", "Request", "RequestState",
           "Scheduler"]
