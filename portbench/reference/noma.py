"""Plain PyTorch reference of the paper's joint round and of its
Monte-Carlo rollout: Age-of-Update admission, strong/weak SIC pairing,
the closed-form max-min power of a pair, the rates and the round time.

Written from the paper's model (DESIGN.md section 4); it imports nothing
of the program. Batched over a leading axis of environments, on any
device, in ``dtype``: float64 for the reference, bfloat16 for the control
(the precision below the engine's float32).

The admission key is A_n * n_n / sum(n), computed in float32 whatever
``dtype`` is above it (the configuration states the key in float32; the
control computes it in its own lower precision). The order is the
lexicographic (key desc, gain desc, client index asc); the admitted are
ranked by gain desc, ties by index; rank p (strong) pairs rank c-1-p
(weak), and an odd count leaves the weakest admitted alone on a
subchannel at full power.
"""
from __future__ import annotations

import torch

AOU_BUCKET_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


def _lexsort_desc(primary, secondary):
    """(B, n) indices by (primary desc, secondary desc, index asc)."""
    o2 = torch.sort(secondary, dim=1, descending=True, stable=True).indices
    o1 = torch.sort(primary.gather(1, o2), dim=1, descending=True,
                    stable=True).indices
    return o2.gather(1, o1)


def pair_power(g_s, g_w, *, n0b: float, pmax: float, bw: float):
    """Max-min power of a SIC pair (strong g_s decoded first, at full
    power): the weak user's received power x solves x (x + N0B) =
    P g_s N0B, clipped at P. Returns (p_s, p_w, r_s, r_w) in bits/s."""
    x = 2.0 * pmax * g_s * n0b / (n0b + torch.sqrt(n0b * n0b
                                                   + 4.0 * pmax * g_s * n0b))
    p_w = torch.clamp(x / torch.clamp(g_w, min=1e-30), max=pmax)
    p_s = torch.full_like(g_s, pmax)
    r_s = bw * torch.log2(1.0 + p_s * g_s / (p_w * g_w + n0b))
    r_w = bw * torch.log2(1.0 + p_w * g_w / n0b)
    return p_s, p_w, r_s, r_w


def schedule(gains, n_samples, cpu_freq, ages, model_bits: float, prm: dict,
             dtype=torch.float64) -> dict:
    """One joint round over (B, N) environments. ``prm``: slots,
    bandwidth_hz, noise_power_w, max_power_w, cycles_per_sample,
    local_epochs. Returns selected (B, N) bool, powers, rates, t_cmp,
    t_com (B, N) and t_round, t_comp_bottleneck, t_up_bottleneck (B,)."""
    b, n = gains.shape
    dev = gains.device
    key_dtype = torch.float32 if dtype == torch.float64 else dtype
    ns_k = n_samples.to(key_dtype)
    key = ages.to(key_dtype) * (ns_k / ns_k.sum(dim=1, keepdim=True))
    g = gains.to(dtype)
    c = min(prm["slots"], n)
    order = _lexsort_desc(key, g)
    sel = torch.zeros((b, n), dtype=torch.bool, device=dev)
    sel.scatter_(1, order[:, :c], True)

    # the admitted by gain desc, ties by index asc
    members = torch.sort(sel.to(torch.uint8), dim=1, descending=True,
                         stable=True).indices[:, :c]          # index asc
    by_gain = torch.sort(g.gather(1, members), dim=1, descending=True,
                         stable=True).indices
    ranked = members.gather(1, by_gain)                       # (B, c)
    g_r = g.gather(1, ranked)
    n0b = float(prm["noise_power_w"])
    pmax = float(prm["max_power_w"])
    bw = float(prm["bandwidth_hz"])
    m = c // 2
    pw_r = torch.zeros((b, c), dtype=dtype, device=dev)
    rate_r = torch.zeros((b, c), dtype=dtype, device=dev)
    if m:
        strong = torch.arange(m, device=dev)
        weak = 2 * m - 1 - strong
        p_s, p_w, r_s, r_w = pair_power(g_r[:, strong], g_r[:, weak],
                                        n0b=n0b, pmax=pmax, bw=bw)
        pw_r[:, strong], pw_r[:, weak] = p_s, p_w
        rate_r[:, strong], rate_r[:, weak] = r_s, r_w
    if c % 2:
        pw_r[:, c - 1] = pmax
        rate_r[:, c - 1] = bw * torch.log2(1.0 + pmax * g_r[:, c - 1] / n0b)
    powers = torch.zeros((b, n), dtype=dtype, device=dev).scatter(
        1, ranked, pw_r)
    rates = torch.zeros((b, n), dtype=dtype, device=dev).scatter(
        1, ranked, rate_r)
    t_cmp = (prm["local_epochs"] * prm["cycles_per_sample"]
             * n_samples.to(dtype) / cpu_freq.to(dtype))
    t_com = model_bits / torch.clamp(rates, min=1e-9)
    tot = torch.where(sel, t_cmp + t_com, 0.0)
    t_round = tot.amax(dim=1)
    bn = tot.argmax(dim=1, keepdim=True)
    return {"selected": sel, "powers": powers, "rates": rates,
            "t_cmp": t_cmp, "t_com": t_com, "t_round": t_round,
            "t_comp_bottleneck": t_cmp.gather(1, bn)[:, 0],
            "t_up_bottleneck": t_com.gather(1, bn)[:, 0]}


def aou_hist(ages):
    """(B, 7) counts of ages in (-inf, 1], (1, 2], ..., (32, inf)."""
    edges = torch.tensor(AOU_BUCKET_EDGES, dtype=ages.dtype,
                         device=ages.device)
    idx = (ages[..., None] > edges).sum(dim=-1)
    return torch.stack([(idx == k).sum(dim=-1)
                        for k in range(len(AOU_BUCKET_EDGES) + 1)], dim=-1)


def rollout(gains_seq, n_samples, cpu_freq, model_bits: float, prm: dict,
            dtype=torch.float64) -> dict:
    """R rounds of AoU selection over (B, N) environments from ages 1:
    gains_seq (R, B, N), n_samples and cpu_freq (B, N). Returns the
    per-round t_round, t_comp_bottleneck, t_up_bottleneck, n_selected,
    max_age (R, B) and aou_hist (R, B, 7) of the ages after each round,
    and the final ages and participation counts (B, N)."""
    r_n, b, n = gains_seq.shape
    ages = torch.ones((b, n), dtype=dtype, device=gains_seq.device)
    part = torch.zeros((b, n), dtype=torch.int64, device=gains_seq.device)
    keys = ("t_round", "t_comp_bottleneck", "t_up_bottleneck",
            "n_selected", "max_age", "aou_hist")
    out = {k: [] for k in keys}
    for r in range(r_n):
        s = schedule(gains_seq[r], n_samples, cpu_freq, ages, model_bits,
                     prm, dtype)
        sel = s["selected"]
        ages = torch.where(sel, torch.ones_like(ages), ages + 1.0)
        part = part + sel.to(torch.int64)
        for k in keys[:3]:
            out[k].append(s[k])
        out["n_selected"].append(sel.sum(dim=1))
        out["max_age"].append(ages.amax(dim=1))
        out["aou_hist"].append(aou_hist(ages))
    res = {k: torch.stack(v) for k, v in out.items()}
    res["final_ages"] = ages
    res["participation"] = part
    return res


def params_of(noma: dict, fl: dict) -> dict:
    """The round model's scalars from a configuration's NOMA and FL
    sections."""
    return {"slots": noma["n_subchannels"] * noma["users_per_subchannel"],
            "bandwidth_hz": noma["bandwidth_hz"],
            "noise_power_w": noma["noise_density"] * noma["bandwidth_hz"],
            "max_power_w": noma["max_power_w"],
            "cycles_per_sample": fl["cpu_cycles_per_sample"],
            "local_epochs": fl["local_epochs"]}


def rel_gap(a, b) -> float:
    """Largest |a - b| / |b| over the entries (0 where both are 0)."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64).to(a.device)
    den = b.abs()
    gap = torch.where(den > 0, (a - b).abs() / den.clamp(min=1e-300),
                      (a - b).abs())
    return float(gap.max()) if gap.numel() else 0.0

