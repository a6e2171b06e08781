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

The backward. Where autograd needs a gradient of a CUDA input, ``wkv6``
applies ``_Wkv6Grad``: its forward is the kernels above, whose scratch
chunk start states it keeps with its ``chunk`` (the frame of the
cumulative sums), and its backward is ``wkv6_bwd``, the hand-written CUDA
kernels of ``csrc/wkv6_bwd.cu``: the forward's chunked algebra run
backward, chunk by chunk on the tensor cores (split-precision TF32 on
``mma.sync``, the products' factors per sub-chunk of 16 steps as the
forward's): each chunk's local dG, a reverse scan of dL/dS over chunks
(the forward's scan run backward), then each chunk's dk, dv and dr from
its start state and G_end, dw_log summed over the steps each pair of
steps spans, and du in a fixed order (five launches, one count, no
atomics). They replace no TPU kernel: the reference takes this gradient
by JAX's autodiff of ``rwkv.wkv6_chunked`` (src/repro/models/rwkv.py:80).
Bound on the H100: one read of the inputs and one write of the
gradients; the recurrence's 14 C^2 operations a step and head, priced
as the forward's are (three times over on the TF32 tensor cores), take
less than that at C = 64. ``wkv6_bwd_plain`` is its plain version, the
same chunked algorithm in fp32. The casts of w_log, u and s0 to fp32
happen outside the Function, so their gradients come back in their own
dtypes. Under ``torch.no_grad()``, or when no input needs a gradient,
the forward launches exactly as before and keeps nothing.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

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


def _check_cuda(r, k, v, ins):
    """The kernels' own limits, for tensors not all on the CPU."""
    dev = r.device
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError("wkv6 takes its tensors on one CUDA device (or all "
                         "on the CPU)")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6 takes fp32 or bf16 r, k, v of one dtype, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    b, h, _, c = r.shape
    if c not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes head size in {HEAD_SIZES}, got "
                         f"{c}")
    if b * h > 65535:
        raise ValueError(f"wkv6 kernel takes B*H <= 65535, got {b * h}")


def wkv6(r, k, v, w_log, u, s0=None, *, chunk: int = CHUNK):
    """(out, s_T): the CUDA kernels for CUDA tensors (their own chunk of
    ``KERNEL_CHUNK`` steps, whatever ``chunk`` is), ``wkv6_plain`` for CPU
    tensors. Where autograd needs a gradient of a CUDA input, the call
    goes through ``_Wkv6Grad``, whose backward is ``wkv6_bwd``'s kernels;
    otherwise nothing is saved."""
    _check(r, k, v, w_log, u, s0, chunk)
    ins = [x for x in (r, k, v, w_log, u, s0) if x is not None]
    if all(x.device.type == "cpu" for x in ins):
        return wkv6_plain(r, k, v, w_log, u, s0, chunk=chunk)
    _check_cuda(r, k, v, ins)
    # cast outside the Function, so that autograd returns dw_log, du and
    # ds0 in their own dtypes
    w_log = w_log.to(torch.float32)
    u = u.to(torch.float32)
    s0 = None if s0 is None else s0.to(torch.float32)
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        return _Wkv6Grad.apply(r, k, v, w_log, u, s0, chunk)
    return _forward(r, k, v, w_log, u, s0, chunk)[:2]


def _forward(r, k, v, w_log, u, s0, chunk):
    """The forward kernels on checked CUDA tensors (w_log, u, s0 fp32),
    through the custom op ``repro_torch::wkv6_fwd``: (out, s_T, the chunk
    start states (B, H, ceil(T/64), C, C), empty where no kernel ran)."""
    return torch.ops.repro_torch.wkv6_fwd(r, k, v, w_log, u, s0, int(chunk))


@torch.library.custom_op("repro_torch::wkv6_fwd", mutates_args=(),
                         device_types="cuda")
def _wkv6_fwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w_log: torch.Tensor, u: torch.Tensor,
                 s0: Optional[torch.Tensor], chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The launches of ``csrc/wkv6.cu`` (one count) with their scratch."""
    dev = r.device
    b, h, t, c = r.shape
    n = -(-t // KERNEL_CHUNK)
    r, k, v = (build.aligned(x) for x in (r, k, v))
    w_log = build.aligned(w_log)
    u = build.aligned(u)
    s0 = (torch.zeros((b, h, c, c), dtype=torch.float32, device=dev)
          if s0 is None else build.aligned(s0))
    out = torch.empty((b, h, t, c), dtype=torch.float32, device=dev)
    s_t = torch.empty((b, h, c, c), dtype=torch.float32, device=dev)
    states = torch.empty((b, h, n, c, c), dtype=torch.float32, device=dev)
    if b * h == 0:
        return out, s_t, states
    if t == 0:
        return out, s_t.copy_(s0), states
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
    return out, s_t, states


@_wkv6_fwd_op.register_fake
def _(r, k, v, w_log, u, s0, chunk):
    b, h, t, c = r.shape
    f32 = dict(dtype=torch.float32)
    return (r.new_empty((b, h, t, c), **f32), r.new_empty((b, h, c, c), **f32),
            r.new_empty((b, h, -(-t // KERNEL_CHUNK), c, c), **f32))


@register_flop_formula(torch.ops.repro_torch.wkv6_fwd)
def wkv6_flops(r_shape, *args, **kwargs) -> int:
    """The recurrence's operations, as the forward's bound prices them
    (which counts each three times over on the TF32 tensor cores): 5 C^2
    a step and head."""
    b, h, t, c = r_shape
    return 5 * c * c * t * h * b


wkv6.launches = 0


class _Wkv6Grad(torch.autograd.Function):
    """``wkv6`` under autograd on the card: the forward kernels, whose
    chunk start states are kept, then ``wkv6_bwd``'s kernels. The
    cotangent of an unused output arrives as None and counts as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, s0, chunk):
        out, s_t, states = _forward(r, k, v, w_log, u, s0, chunk)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w_log, u, s0, states)
        return out, s_t

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, ds_t):
        r, k, v, w_log, u, s0, states = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w_log, u, s0, dout, ds_t,
                                           states=states, chunk=ctx.chunk)
        return dr, dk, dv, dw, du, None if s0 is None else ds0, None


def _serial_cumsum(x, frame):
    """fp32 cumulative sum over dim 2 of (B, H, T, C), added in series and
    restarted every ``frame`` steps: the order in which the kernels' one
    thread a column adds, on any device."""
    b, h, t, c = x.shape
    m = -(-t // frame)
    x = torch.nn.functional.pad(x, (0, 0, 0, m * frame - t)).reshape(
        b, h, m, frame, c)
    out, acc = torch.empty_like(x), torch.zeros_like(x[:, :, :, 0])
    for i in range(frame):
        acc = acc + x[:, :, :, i]
        out[:, :, :, i] = acc
    return out.reshape(b, h, m * frame, c)[:, :, :t]


def wkv6_bwd_plain(r, k, v, w_log, u, s0, dout, ds_T, *, chunk: int = CHUNK):
    """Plain version of ``wkv6_bwd``, by its kernels' algorithm in fp32:
    chunks of ``KERNEL_CHUNK`` steps with the cumulative log-decays of
    ``cumsum_frame(T, chunk)`` (lp, lp_prev = lp - w_log, base: lp at the
    step before the chunk in its frame), the chunk start states S_j from
    ``s0`` (None is zero), the chunks' local dG_j = (R e^{lp_prev -
    base})^T dO, the reverse scan G_end,j-1 = diag(e^{lp_L,j}) G_end,j +
    dG_j from ``ds_T`` (None is zero), then inside each chunk, with B =
    dO V^T and beta = diag(B):

        dr = e^{lp_prev - base} (dO S_j^T) + intra_r + adj_r + u k beta
        dk = e^{lp_L - lp} (V G_end^T)   + intra_k + adj_k + u r beta
        dv = A^T dO + (K e^{lp_L - lp}) G_end

    where intra_r, intra_k take the pairs s < t - 1 (B's entries below
    its subdiagonal, pairwise decays e^{lp_prev_t - lp_s}) and adj_r,
    adj_k the adjacent pairs s = t - 1. dw_log sums each pair's term
    over the steps it spans (s < i < t), so a term never enters once
    through r and leaves once through k: with Y = k e^{lp_L - lp}
    (V G_end^T), F = k intra_k, P = r (e^{lp_prev - base} (dO S_j^T) +
    intra_r) and Z = e^{lp_L - base} sum_d S_j G_end,

        dw_i = (Z + sum_{s<i} Y_s) - sum_{s>=i} F_s + sum_{t>i} P_t,

    the adjacent pairs spanning no step. du = sum over b and t of r k
    beta, ds0 = G_start of chunk 0. Returns (dr, dk, dv) in r's dtype
    and (dw_log, du, ds0) fp32."""
    b, h, t, c = r.shape
    dev = r.device
    L = KERNEL_CHUNK
    n = -(-t // L)
    frame = cumsum_frame(t, chunk)
    pad = torch.nn.functional.pad

    def blocks(x):
        return pad(x.float(), (0, 0, 0, n * L - t)).reshape(b, h, n, L, c)

    def expn(x):
        return torch.exp(torch.clamp(x, max=0.0))

    rr, kk, vv, ww, do = (blocks(x) for x in (r, k, v, w_log, dout))
    wpad = ww.reshape(b, h, n * L, c)
    # chunk-local lp (the forward's states) and lp in the frame
    lp_loc = _serial_cumsum(wpad, L).reshape(b, h, n, L, c)
    lp = _serial_cumsum(wpad, frame).reshape(b, h, n, L, c)
    lpp = lp - ww
    base = torch.zeros_like(lp[:, :, :, 0])
    if frame == 2 * L:
        base[:, :, 1::2] = lp_loc[:, :, 0:n - 1:2, -1]
    last = lp[:, :, :, -1]
    e_pp = expn(lpp - base[:, :, :, None])              # e^{lp_prev - base}
    e_k = expn(last[:, :, :, None] - lp)                # e^{lp_L - lp}
    # the forward's chunk start states
    zero = torch.zeros((b, h, c, c), dtype=torch.float32, device=dev)
    s = zero if s0 is None else s0.float()
    ds = torch.einsum("bhnsc,bhnsd->bhncd",
                      kk * expn(lp_loc[:, :, :, -1:] - lp_loc), vv)
    starts = []
    for j in range(n):
        starts.append(s)
        s = expn(lp_loc[:, :, j, -1])[..., None] * s + ds[:, :, j]
    # the reverse scan of dL/dS over chunks
    dg = torch.einsum("bhntc,bhntd->bhncd", rr * e_pp, do)
    g = zero if ds_T is None else ds_T.float()
    ends = [None] * n
    for j in reversed(range(n)):
        ends[j] = g
        g = expn(last[:, :, j] - base[:, :, j])[..., None] * g + dg[:, :, j]
    uf = u.float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev), -1)
    far = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev), -2)
    outs = [[] for _ in range(4)]
    du = torch.zeros((h, c), dtype=torch.float32, device=dev)
    for j in range(n):
        rc, kc, vc, dc = rr[:, :, j], kk[:, :, j], vv[:, :, j], do[:, :, j]
        sj, ge = starts[j], ends[j]
        dmat = expn(lpp[:, :, j, :, None] - lp[:, :, j, None])  # (t, s, c)
        bmat = torch.einsum("bhtd,bhsd->bhts", dc, vc)
        beta = torch.diagonal(bmat, dim1=2, dim2=3)
        bsub = torch.diagonal(bmat, offset=-1, dim1=2, dim2=3)  # B[t, t-1]
        adj = bsub[..., None] * dmat[:, :, 1:, :-1].diagonal(
            dim1=2, dim2=3).transpose(2, 3)                  # (t-1 rows)
        bfar = torch.where(far, bmat, 0.0)
        a = torch.einsum("bhtc,bhsc,bhtsc->bhts", rc, kc, dmat)
        a = torch.where(tri, a, 0.0) + torch.diag_embed(
            torch.einsum("bhtc,hc,bhtc->bht", rc, uf, kc))
        inter_r = e_pp[:, :, j] * torch.einsum("bhtd,bhcd->bhtc", dc, sj)
        intra_r = torch.einsum("bhts,bhsc,bhtsc->bhtc", bfar, kc, dmat)
        intra_k = torch.einsum("bhts,bhtc,bhtsc->bhsc", bfar, rc, dmat)
        state_k = e_k[:, :, j] * torch.einsum("bhsd,bhcd->bhsc", vc, ge)
        ub = uf[None, :, None] * beta[..., None]
        dr = inter_r + intra_r + ub * kc
        dr[:, :, 1:] += adj * kc[:, :, :-1]
        dk = state_k + intra_k + ub * rc
        dk[:, :, :-1] += adj * rc[:, :, 1:]
        dv = torch.einsum("bhts,bhtd->bhsd", a, dc) + torch.einsum(
            "bhsc,bhcd->bhsd", kc * e_k[:, :, j], ge)
        z = expn(last[:, :, j] - base[:, :, j]) * (sj * ge).sum(-1)
        y, f, p = kc * state_k, kc * intra_k, rc * (inter_r + intra_r)
        before = pad(torch.cumsum(y[:, :, :-1], 2), (0, 0, 1, 0))  # s < i
        from_i = torch.flip(torch.cumsum(torch.flip(f, (2,)), 2), (2,))
        after = pad(torch.flip(torch.cumsum(torch.flip(p[:, :, 1:], (2,)),
                                            2), (2,)), (0, 0, 0, 1))  # t > i
        dw = (z[:, :, None] + before) - from_i + after
        du += (rc * kc * beta[..., None]).sum((0, 2))
        for acc, x in zip(outs, (dr, dk, dv, dw)):
            acc.append(x)
    dr, dk, dv, dw = (torch.stack(x, 2).reshape(b, h, n * L, c)[:, :, :t]
                      for x in outs)
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du, g


def wkv6_bwd(r, k, v, w_log, u, s0, dout, ds_T, *, states,
             chunk: int = CHUNK):
    """(dr, dk, dv, dw_log, du, ds0) of ``wkv6`` for the cotangents ``dout``
    of out and ``ds_T`` of s_T (None: zero): the CUDA kernels of
    ``csrc/wkv6_bwd.cu`` for CUDA tensors (five launches, one count),
    ``wkv6_bwd_plain`` for CPU tensors. ``states`` is the forward's chunk
    start states (``_forward``'s third output), which the kernels need;
    the plain version recomputes them and takes None. ``chunk`` is the
    forward's, whose frame (``cumsum_frame``) both sum their cumulative
    log-decays over. dr, dk, dv in r's dtype, the rest fp32."""
    _check(r, k, v, w_log, u, s0, chunk)
    ins = [x for x in (r, k, v, w_log, u, s0, dout, ds_T) if x is not None]
    if dout.shape != r.shape or (ds_T is not None
                                 and ds_T.shape != (*r.shape[:2],
                                                    r.shape[3], r.shape[3])):
        raise ValueError(f"wkv6_bwd takes dout {tuple(r.shape)} and ds_T "
                         f"(B,H,C,C), got {tuple(dout.shape)}, "
                         f"{None if ds_T is None else tuple(ds_T.shape)}")
    if all(x.device.type == "cpu" for x in ins):
        return wkv6_bwd_plain(r, k, v, w_log, u, s0, dout, ds_T, chunk=chunk)
    _check_cuda(r, k, v, ins)
    dev = r.device
    b, h, t, c = r.shape
    w_log, u = w_log.to(torch.float32), u.to(torch.float32)
    if b * h == 0 or t == 0:
        return (*(torch.zeros(r.shape, dtype=r.dtype, device=dev)
                  for _ in range(3)),
                torch.zeros(r.shape, dtype=torch.float32, device=dev),
                torch.zeros((h, c), dtype=torch.float32, device=dev),
                torch.zeros((b, h, c, c), dtype=torch.float32, device=dev)
                if ds_T is None else ds_T.to(torch.float32).clone())
    n = -(-t // KERNEL_CHUNK)
    if states is None or tuple(states.shape) != (b, h, n, c, c):
        raise ValueError(f"wkv6_bwd takes the forward's states "
                         f"{(b, h, n, c, c)}, got "
                         f"{None if states is None else tuple(states.shape)}")
    return torch.ops.repro_torch.wkv6_bwd(r, k, v, w_log, u, dout, ds_T,
                                          states, int(chunk))


@torch.library.custom_op("repro_torch::wkv6_bwd", mutates_args=(),
                         device_types="cuda")
def _wkv6_bwd_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w_log: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                 ds_T: Optional[torch.Tensor], states: torch.Tensor,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The launches of ``csrc/wkv6_bwd.cu`` (one count) with their
    scratch."""
    dev = r.device
    b, h, t, c = r.shape
    n = -(-t // KERNEL_CHUNK)
    r, k, v = (build.aligned(x) for x in (r, k, v))
    w_log, u = build.aligned(w_log), build.aligned(u)
    dout = build.aligned(dout.to(torch.float32))
    ds_t = (torch.zeros((b, h, c, c), dtype=torch.float32, device=dev)
            if ds_T is None else build.aligned(ds_T.to(torch.float32)))
    dr, dk, dv = (torch.empty((b, h, t, c), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty((b, h, t, c), dtype=torch.float32, device=dev)
    du = torch.empty((h, c), dtype=torch.float32, device=dev)
    ds0 = torch.empty((b, h, c, c), dtype=torch.float32, device=dev)
    # scratch: each chunk's dG, then its G_end; its decay, its Z and its
    # part of du
    dg = torch.empty((b, h, n, c, c), dtype=torch.float32, device=dev)
    lpe, zs, du_part = (torch.empty((b, h, n, c), dtype=torch.float32,
                                    device=dev) for _ in range(3))
    lib = build.load()
    code = lib.repro_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        u.data_ptr(), dout.data_ptr(), ds_t.data_ptr(), states.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du.data_ptr(), ds0.data_ptr(), dg.data_ptr(), lpe.data_ptr(),
        zs.data_ptr(), du_part.data_ptr(), _DTYPES[r.dtype], b, h, t, c, n,
        cumsum_frame(t, chunk), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.count_launch(wkv6_bwd)
    build.check(code, "wkv6_bwd")
    return dr, dk, dv, dw, du, ds0


@_wkv6_bwd_op.register_fake
def _(r, k, v, w_log, u, dout, ds_T, states, chunk):
    b, h, t, c = r.shape
    f32 = dict(dtype=torch.float32)
    return (*(r.new_empty((b, h, t, c)) for _ in range(3)),
            r.new_empty((b, h, t, c), **f32), r.new_empty((h, c), **f32),
            r.new_empty((b, h, c, c), **f32))


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def wkv6_bwd_flops(r_shape, *args, **kwargs) -> int:
    """The gradient's operations, as the backward's bound prices them
    (each three times over on the TF32 tensor cores): 14 C^2 a step and
    head."""
    b, h, t, c = r_shape
    return 14 * c * c * t * h * b


wkv6_bwd.launches = 0
