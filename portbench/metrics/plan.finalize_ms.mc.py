"""plan.finalize_ms.mc: milliseconds a Monte-Carlo round spends in the
engine's finish (ranking, pairing, power, rates, round time: the port's
fenced span ``plan.finalize``), over the traced run's unprofiled
rollouts."""


def read(ctx):
    t = [d for n, d in ctx["port_spans"] if n == "plan.finalize"]
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
