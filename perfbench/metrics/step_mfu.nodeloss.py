"""step_mfu.nodeloss: `step_mfu` in the node-loss cell, where it moves
`goodput_tokens_per_s` (the same reader: every step the window ran,
replayed steps included)."""
from perfbench import spec

read = spec.reader("step_mfu")
