"""plan.diag_ms.mc: milliseconds a Monte-Carlo round spends after its
schedule, in the age update and the round's diagnostics (the AoU
histogram, the counts, the bottleneck times and the largest age: the
port's fenced span ``plan.diag``), over the traced run's unprofiled
rollouts."""


def read(ctx):
    t = [d for n, d in ctx["port_spans"] if n == "plan.diag"]
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
