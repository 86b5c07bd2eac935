"""Deterministic synthetic datasets (numpy copy of ``repro.data``)."""
