"""pairscore_roofline.mc: the pairscore kernel's share of its byte bound
(24 bytes a pair) over its device time in the profiled rollouts; each
launch scores one round's S x slots/2 strong/weak pairs."""
from portbench import formulas
from portbench.harness import kernel_time


def read(ctx):
    launches, seconds = kernel_time(ctx["timeline"]["kernels"], "pairscore")
    if not launches:
        return None
    least = launches * formulas.pairscore_bytes(ctx["pairscore_elements"]) \
        / formulas.PEAK_HBM_BYTES
    return formulas.roofline_pct(least, seconds)
