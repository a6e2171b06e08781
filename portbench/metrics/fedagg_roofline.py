"""fedagg_roofline: the fedagg kernel's share of its byte bound, over its
device time in the profiled rounds (each launch sums one round's client
deltas: rows x P fp32 read, P fp32 written)."""
from portbench import formulas
from portbench.harness import kernel_time


def read(ctx):
    launches, seconds = kernel_time(ctx["timeline"]["kernels"], "fedagg")
    if not launches:
        return None
    least = launches * formulas.fedagg_bytes(ctx["fedagg_rows"],
                                             ctx["n_params"]) \
        / formulas.PEAK_HBM_BYTES
    return formulas.roofline_pct(least, seconds)
