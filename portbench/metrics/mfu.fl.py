"""mfu.fl: the FL rounds' model FLOPs (PaLM's count from the widths, over
the positions each local step trains on) over the rounds' seconds, as a
share of the card's bf16 dense peak, in the traced run's unprofiled
rounds."""
from portbench import formulas


def read(ctx):
    rounds = ctx["spans"].steady("unit")
    seconds = sum(s for s, _ in rounds)
    steps = sum(m["work"] for _, m in rounds)
    if not seconds or not steps:
        return None
    return 100.0 * steps * ctx["flops_per_step"] / seconds \
        / formulas.PEAK_BF16_FLOPS
