"""fl.local_sgd_ms_per_step: milliseconds of ``LocalTrainer.local_update``
(weight copy, forward, loss, backward, SGD, the delta write) per local SGD
step, from the benchmark's fenced spans in the traced run's unprofiled
rounds."""


def read(ctx):
    rounds = ctx["spans"].steady("unit")
    local = ctx["spans"].steady("local_update")
    steps = sum(m["work"] for _, m in rounds)
    if not local or not steps:
        return None
    return 1e3 * sum(s for s, _ in local) / steps
