"""device_idle_share.nodeloss: `device_idle_share` in the node-loss cell,
where the traced stretch is the window's first cycle of steps and the
restore that ends it, and where it moves `goodput_tokens_per_s` (the
same reader)."""
from perfbench import spec

read = spec.reader("device_idle_share")
