"""Chunked RWKV6 WKV recurrence with an initial and a final state.

    S_t   = diag(exp(w_log_t)) S_{t-1} + k_t v_t^T
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Counterpart of ``src/repro/kernels/wkv6.py`` (``wkv6_pallas``) and of the
reference model's ``rwkv.wkv6_chunked``: r, k, v (B,H,T,C), w_log (B,H,T,C)
non-positive log-decays, u (H,C), s0 (B,H,C,C) -> out (B,H,T,C) fp32 and
s_T (B,H,C,C) fp32.

``wkv6`` is the wrapper of the hand-written CUDA kernels ``csrc/wkv6.cu``,
which replace the TPU kernel ``_wkv6_kernel`` (src/repro/kernels/wkv6.py:36)
and, unlike it, take ``s0`` and return ``s_T``. They split T over CTAs in
chunks of 64 steps: a chunk-state pass, a scan over chunks from ``s0``, an
output pass; inside a chunk the decays are factorised per sub-chunk of 16
steps (every exponent <= 0) and the products run on the tensor cores in
split-precision TF32 (see the source's note). The function does not depend
on the chunk size, so the kernels tile with their own chunk whatever
``chunk`` names; ``chunk`` still chooses the plain version's blocks, and
the kernels add their cumulative log-decays in series over the same
blocks where those are 64 or 128 steps or all of T (``cumsum_frame``), so
that they round as the plain version's do. That matters only where the
decays are extreme: with every w_log at the +4 clip the plain version's
lp - w_log misses the adjacent step's exact decay by up to one ulp of lp.
Bound on the H100: one read of the inputs and one write of the outputs.
The recurrence's ~5 C^2 operations per token and head, run three times
over on the TF32 tensor cores (3xTF32), take less than that at C = 64.
The wrapper allocates the kernels' scratch, the chunk states (B, H,
ceil(T/64), C, C) fp32 and the chunks' total log-decays (B, H, ceil(T/64),
C) fp32, and passes its chunk count, which the C entry refuses unless it
is the kernels' own.

``wkv6_plain`` is the plain PyTorch version: the ``wkv6_chunked`` formulas,
chunk by chunk, with the pairwise decays exp(min(lp_prev_t - lp_s, 0))
(no factorised form: lp reaches about -7000 over a chunk of 128 steps).
A tail chunk is padded with zeros, which changes neither the state nor
the cumulative decays, so T need not be a multiple of ``chunk``. The
wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernels or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 64)         # the reduced and the full rwkv6
MAX_CHUNK = 128
CHUNK = 64                    # the Pallas kernel's default chunk
KERNEL_CHUNK = 64             # the CUDA kernels' own chunk (csrc/wkv6.cu)


def wkv6_plain(r, k, v, w_log, u, s0=None, *, chunk: int = CHUNK):
    """(out (B,H,T,C) fp32, s_T (B,H,C,C) fp32); ``s0`` None is zero."""
    b, h, t, c = r.shape
    s = (torch.zeros((b, h, c, c), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    if t == 0:
        return torch.zeros((b, h, 0, c), device=r.device), s
    chunk = min(chunk, t)
    n = -(-t // chunk)
    pad = n * chunk - t

    def blocks(x):
        x = x.float()
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.reshape(b, h, n, chunk, c)

    rr, kk, vv, ww = (blocks(x) for x in (r, k, v, w_log))
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    eye = torch.eye(chunk, device=r.device)
    outs = []
    for i in range(n):
        rc, kc, vc, wc = rr[:, :, i], kk[:, :, i], vv[:, :, i], ww[:, :, i]
        lp = torch.cumsum(wc, dim=2)                 # inclusive
        lp_prev = lp - wc                            # exclusive
        inter = torch.einsum("bhtc,bhcd->bhtd", rc * torch.exp(lp_prev), s)
        dmat = torch.exp(torch.clamp(lp_prev[:, :, :, None, :]
                                     - lp[:, :, None, :, :], max=0.0))
        a = torch.einsum("bhtc,bhsc,bhtsc->bhts", rc, kc, dmat)
        a = torch.where(tri, a, 0.0)
        bonus = torch.einsum("bhtc,hc,bhtc->bht", rc, uf, kc)
        a = a + eye * bonus[..., None]
        outs.append(inter + torch.einsum("bhts,bhsd->bhtd", a, vc))
        dec_all = torch.exp(lp[:, :, -1])                     # (B,H,C)
        k_dec = kc * torch.exp(lp[:, :, -1:, :] - lp)
        s = dec_all[..., None] * s + torch.einsum("bhsc,bhsd->bhcd", k_dec,
                                                  vc)
    out = torch.stack(outs, dim=2).reshape(b, h, n * chunk, c)[:, :, :t]
    return out, s


def _check(r, k, v, w_log, u, s0, chunk):
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w_log)):
        raise ValueError(f"wkv6 takes r, k, v, w_log of one (B,H,T,C) shape, "
                         f"got {[tuple(x.shape) for x in (r, k, v, w_log)]}")
    b, h, _, c = r.shape
    if tuple(u.shape) != (h, c):
        raise ValueError(f"wkv6 takes u (H, C) = {(h, c)}, got "
                         f"{tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (b, h, c, c):
        raise ValueError(f"wkv6 takes s0 (B,H,C,C) = {(b, h, c, c)}, got "
                         f"{tuple(s0.shape)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6 takes 1 <= chunk <= {MAX_CHUNK}, got {chunk}")


def cumsum_frame(t: int, chunk: int) -> int:
    """Steps over which the kernels' cumulative log-decays run before they
    restart: 2 * KERNEL_CHUNK where the plain version's blocks (``min(chunk,
    t)`` steps) are that long or hold all of T, else KERNEL_CHUNK. The sums
    then round as the plain version's do (see csrc/wkv6.cu)."""
    block = min(chunk, t)
    wide = block == 2 * KERNEL_CHUNK or KERNEL_CHUNK < block == t
    return 2 * KERNEL_CHUNK if wide else KERNEL_CHUNK


def wkv6(r, k, v, w_log, u, s0=None, *, chunk: int = CHUNK):
    """(out, s_T): the CUDA kernels for CUDA tensors (their own chunk of
    ``KERNEL_CHUNK`` steps, whatever ``chunk`` is), ``wkv6_plain`` for CPU
    tensors."""
    _check(r, k, v, w_log, u, s0, chunk)
    ins = [x for x in (r, k, v, w_log, u, s0) if x is not None]
    if all(x.device.type == "cpu" for x in ins):
        return wkv6_plain(r, k, v, w_log, u, s0, chunk=chunk)
    dev = r.device
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError("wkv6 takes its tensors on one CUDA device (or all "
                         "on the CPU)")
    build.refuse_grad("wkv6", *ins)
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6 takes fp32 or bf16 r, k, v of one dtype, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    b, h, t, c = r.shape
    if c not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes head size in {HEAD_SIZES}, got "
                         f"{c}")
    r, k, v = (build.aligned(x) for x in (r, k, v))
    w_log = build.aligned(w_log.to(torch.float32))
    u = build.aligned(u.to(torch.float32))
    s0 = (torch.zeros((b, h, c, c), dtype=torch.float32, device=dev)
          if s0 is None else build.aligned(s0.to(torch.float32)))
    out = torch.empty((b, h, t, c), dtype=torch.float32, device=dev)
    s_t = torch.empty((b, h, c, c), dtype=torch.float32, device=dev)
    if b * h == 0:
        return out, s_t
    if t == 0:
        return out, s_t.copy_(s0)
    if b * h > 65535:
        raise ValueError(f"wkv6 kernel takes B*H <= 65535, got {b * h}")
    n = -(-t // KERNEL_CHUNK)
    states = torch.empty((b, h, n, c, c), dtype=torch.float32, device=dev)
    lp_end = torch.empty((b, h, n, c), dtype=torch.float32, device=dev)
    lib = build.load()
    code = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w_log.data_ptr(), u.data_ptr(), s0.data_ptr(),
                          out.data_ptr(), s_t.data_ptr(), states.data_ptr(),
                          lp_end.data_ptr(), _DTYPES[r.dtype], b, h, t, c,
                          n, cumsum_frame(t, chunk), dev.index,
                          torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(wkv6)
    build.check(code, "wkv6")
    return out, s_t


wkv6.launches = 0
