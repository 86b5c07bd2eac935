"""Circuit library of the port: numpy copies of ``repro.core`` (gates,
netlists, seeds, families, LUTs, error metrics, cost, CGP, library)."""
