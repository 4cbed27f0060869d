"""ssd_scan_roofline: the SSD kernels' share of their roofline over the
traced stretch: the least time of the forward and backward calls the
stretch launched (`formulas.ssd_bound_s` at the cell's shape, the
program's launch counters), over the device time of the SSD kernels."""
import re

from perfbench.formulas import chunk_len, ssd_bound_s
from perfbench.weights import ssm_dims

KERNELS = re.compile(r"^(chunk_state|state_pass|cb|scan_fwd|ds|duda|dbdc)"
                     r"_kernel$")


def read(rec):
    t = rec["trace"]
    if not t or rec["config"]["family"] != "ssm":
        return None
    c, tr = rec["config"], rec["traffic"]
    secs = sum(s for name, (_, s) in t["kernels"].items()
               if KERNELS.match(name))
    n_f, n_b = t["launches"].get("ssd_scan", 0), \
        t["launches"].get("ssd_scan_bwd", 0)
    if not secs or not (n_f or n_b):
        return None
    _, H, _ = ssm_dims(c)
    B, S = tr["batch"], tr["seq"]
    f, b = ssd_bound_s(B, S, H, c["ssm_head_dim"], c["ssm_state"],
                       chunk_len(S, c["ssd_chunk"]))
    return 100.0 * (n_f * f + n_b * b) / secs
