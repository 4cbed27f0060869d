"""step_p90_s: the 90th percentile of every window step's host-clock
time, from the batch's feed through `float(loss)` (which synchronises)
and the step's `after_step`."""
import statistics


def read(rec):
    s = rec["window"]["step_seconds"]
    if len(s) < 2:
        return None
    return statistics.quantiles(s, n=10, method="inclusive")[-1]
