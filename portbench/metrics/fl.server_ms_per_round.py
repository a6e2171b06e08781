"""fl.server_ms_per_round: milliseconds a FL round spends outside local
training (scenario step, selection through the engine, aggregation, age
update), from the benchmark's fenced spans around each round and each
``LocalTrainer.local_update`` in the traced run's unprofiled rounds."""


def read(ctx):
    rounds = ctx["spans"].steady("unit")
    local = ctx["spans"].steady("local_update")
    if not rounds or not local:
        return None
    return 1e3 * (sum(s for s, _ in rounds) - sum(s for s, _ in local)) \
        / len(rounds)
