"""setup_s: process start to the first step of the window (loading, the
kernels' build on a checkout's first run, weights, the session, the
three checked steps and the warm-up), host clock."""


def read(rec):
    return rec["setup_s"]
