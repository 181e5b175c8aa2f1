"""Hardware points the deployment planner prices against: verbatim copies
of ``repro.core.hardware`` (chip constants) and ``repro.core.hbmco`` (the
HBM-CO design space); both are pure Python."""
