"""device_idle_share: the share of the traced stretch in which no kernel,
copy or memset ran on the card (1 - the union of their intervals over
the stretch), in percent."""


def read(rec):
    t = rec["trace"]
    if not t or not t["stretch_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["stretch_s"])
