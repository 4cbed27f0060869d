"""after_step_ms: the mean of the harness's host-clock span around each
window step's `sess.after_step` (the facade, and the L1 pump it ticks on
the trainer's thread), in milliseconds: the spans' sum over their count,
so that the sum is long against the clock's error."""


def read(rec):
    s = rec["window"]["after_step_seconds"]
    return 1e3 * sum(s) / len(s) if s else None
