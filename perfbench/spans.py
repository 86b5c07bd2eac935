"""Host spans the benchmark opens around its calls into the program's
layers (``record_function`` ranges named ``pb.*``), read back from the
traced window: ``pb.pass`` around a whole banked pass, and
``pb.datapath.<layer>`` around each call into the datapath layer
(``policy.matmul``: calibration, the kernel, the epilogue)."""
from __future__ import annotations

import contextlib

from torch.profiler import record_function


class SpanPolicy:
    """A policy whose every ``matmul`` runs inside a
    ``pb.datapath.<layer>`` span; anything else is the wrapped
    policy's."""

    def __init__(self, policy):
        self._policy = policy

    def matmul(self, name, x, w, lanes=False, experts=False):
        with record_function(f"pb.datapath.{name}"):
            return self._policy.matmul(name, x, w, lanes=lanes,
                                       experts=experts)

    def __getattr__(self, attr):
        return getattr(self._policy, attr)


def pass_scope(traced: bool):
    """(the policy wrapper, the context) of one pass: spans when traced,
    the policy as it is and no span otherwise."""
    if traced:
        return SpanPolicy, record_function("pb.pass")
    return (lambda policy: policy), contextlib.nullcontext()
