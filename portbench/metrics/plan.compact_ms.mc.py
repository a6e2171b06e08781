"""plan.compact_ms.mc: milliseconds a Monte-Carlo round spends compacting
the admitted set (the sort of the admission mask and the rank sort of
the admitted gains: the port's fenced span ``plan.compact``, inside
``plan.finalize``), over the traced run's unprofiled rollouts."""


def read(ctx):
    t = [d for n, d in ctx["port_spans"] if n == "plan.compact"]
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
