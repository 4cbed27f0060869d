"""Concurrency & protocol analysis: the AST lint rules (`lint`), the
lock-order tracer the SMP runs with (`lockgraph`), the SMP protocol model
checker and validator (`protocol`), and the gate over all three, `python
-m repro_torch.analyze` (`cli`). Stdlib-only, like the modules that
import it."""
