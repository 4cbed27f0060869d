"""replayed_steps.nodeloss: the steps rolled back a failure (the step it
struck at minus the step restored, as the program's restore reports it),
the mean over the window's failures."""


def read(rec):
    r = rec["window"]["restores"]
    return sum(x["failed_at"] - x["restored"] for x in r) / len(r) if r \
        else None
