"""encode_bucket_roofline: the device encode's share of its roofline over
the traced stretch: the launches the trace holds times the mean bytes of
a launch in a snapshot round (`formulas.encode_flight`: own buckets read
and written, parity buckets n - 1 rows folded into one) at 3.35 TB/s,
over the device time of the encode kernels."""
import re

from perfbench.formulas import encode_flight, state_bytes
from perfbench.peaks import HBM_BYTES_PER_S

KERNEL = re.compile(r"^encode_kernel<(true|false)>$")
BUCKET = 4 << 20


def read(rec):
    t = rec["trace"]
    tr = rec["traffic"]
    if not t or tr["backend"] != "reft":
        return None
    hits = [v for name, v in t["kernels"].items() if KERNEL.match(name)]
    count, secs = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not count or not secs:
        return None
    moved, launches = encode_flight(state_bytes(rec["config"]),
                                    rec["sg_size"], BUCKET)
    return 100.0 * count * moved / launches / HBM_BYTES_PER_S / secs
