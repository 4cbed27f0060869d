"""step_mfu: the whole step's share of the card's bf16 peak: model FLOPs
of a step (`formulas.model_flops`) x the steps the window completed,
over the window's seconds and 989.4 TFLOP/s, in percent."""
from perfbench.formulas import model_flops
from perfbench.peaks import BF16_FLOPS


def read(rec):
    w, tr = rec["window"], rec["traffic"]
    flops = model_flops(rec["config"], tr["batch"], tr["seq"]) * w["steps"]
    return 100.0 * flops / w["seconds"] / BF16_FLOPS
