"""goodput_tokens_per_s: tokens of the window's steps that no restore
rolled back, over the window's seconds: the restores' time and the
replayed steps count against it."""


def read(rec):
    w = rec["window"]
    return w["steps_kept"] * w["tokens_per_step"] / w["seconds"]
