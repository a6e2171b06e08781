"""plan.admit_ms.mc: milliseconds a Monte-Carlo round spends in the
engine's admission (the port's fenced span ``plan.admit``), over the
traced run's unprofiled rollouts."""


def read(ctx):
    t = [d for n, d in ctx["port_spans"] if n == "plan.admit"]
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
