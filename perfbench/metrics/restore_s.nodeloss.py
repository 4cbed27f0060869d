"""restore_s.nodeloss: the median over the window's failures of the
harness's span from the injection to the restored state back on the card
(the session's recovery ladder, the RAIM5 decode, the heal)."""
import statistics


def read(rec):
    r = rec["window"]["restores"]
    return statistics.median(x["seconds"] for x in r) if r else None
