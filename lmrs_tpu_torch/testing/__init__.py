"""Test-support code that ships in the package because the port's own code
paths call into it: the deterministic fault-injection plane
(``testing.faults``), a no-op when no plan is installed."""
