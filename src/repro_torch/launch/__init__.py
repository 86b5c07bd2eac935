"""Entry points of the port (``repro.launch`` counterpart)."""


class GateError(RuntimeError):
    """A gate of an entry point failed: ``gate`` names it, ``record``
    holds what was measured (each entry point's ``main`` writes it to
    ``--out`` before the error propagates)."""

    def __init__(self, message: str, gate: str, record: dict):
        super().__init__(message)
        self.gate = gate
        self.record = record
