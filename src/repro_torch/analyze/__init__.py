"""Concurrency & protocol analysis the SMP runs with: the lock-order
tracer (`lockgraph`) and the SMP protocol validator (`protocol`).
Stdlib-only, like the modules that import it."""
