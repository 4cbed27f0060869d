"""tokens_per_s: tokens of every optimizer step completed in the window
over the window's seconds (host clock, the window closed by a device
synchronise)."""


def read(rec):
    w = rec["window"]
    return w["steps"] * w["tokens_per_step"] / w["seconds"]
