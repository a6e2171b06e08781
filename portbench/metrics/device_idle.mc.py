"""device_idle.mc: the share of the profiled Monte-Carlo rollouts in which no kernel,
copy or set ran on the card (torch.profiler's device timeline)."""


def read(ctx):
    window = ctx["traced_window_s"]
    if not window or not ctx["timeline"]["kernels"]:
        return None
    return 100.0 * (1.0 - ctx["timeline"]["busy_s"] / window)
