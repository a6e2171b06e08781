"""Port chunked WKV6 (src/repro_torch/kernels/wkv6.py) against the reference
on the CPU, in fp32, from the same numpy inputs.

``split_mirror`` repeats, in plain fp32 PyTorch, the decomposition of the
CUDA kernels (csrc/wkv6.cu), which cannot run here: chunks of 64 steps, a
chunk-state pass, a scan over chunks, and an output pass whose intra-chunk
matrix is factorised per sub-chunk of 16 steps, and within a sub-chunk per
half of 8, with only the 8 x 8 diagonal blocks pairwise; the cumulative
log-decays are added in series over the frames ``cumsum_frame`` names, as
the kernels add them. It checks that every factorised exponent is <= 0
(up to one rounding of lp), so the overflow argument of the kernel's note
is held where there is no card.

Tolerances, relative to the largest magnitude of the compared output:
- 2e-4 against the naive recurrence ``ref.wkv6_ref`` and the Pallas
  interpreter (the chunked form sums in another order; the reference's own
  tests hold its chunked paths to 2e-4);
- 1e-5 against the reference's ``rwkv.wkv6_chunked`` (the same formulas,
  summed in another order), also with w at the +4 clip, where lp falls to
  about -7000 over a chunk of 128;
- 1e-5 for ``split_mirror`` against ``rwkv.wkv6_chunked``, and against
  ``ref.wkv6_ref`` off the clip. At the +4 clip the chunked form itself
  (and so the mirror, which rounds its cumulative decays the same way) is
  held to the recurrence at 2e-4: its lp_prev = lp - w_log, at |lp| in the
  thousands, moves the adjacent step's decay exp(0) by up to one ulp of lp
  (2^-11 at |lp| in [4096, 8192)). Measured: the mirror's out lies
  8.83e-5 (case clip) and 8.89e-5 (case t_off_chunk) of max|out| from
  ``ref.wkv6_ref``, and 5.0e-8 and 1.7e-7 from ``rwkv.wkv6_chunked``;
  s_T agrees exactly with both.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rwkv as jrwkv
from repro_torch.kernels import ops, wkv6


def inputs(b, h, t, c, seed, *, clip=False, s0=True):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((b, h, t, c)).astype(f) * 0.5
               for _ in range(3))
    wt = (np.full((b, h, t, c), 4.0, f) if clip
          else rng.standard_normal((b, h, t, c)).astype(f))
    w_log = -np.exp(np.clip(wt, -8.0, 4.0)).astype(f)
    u = rng.standard_normal((h, c)).astype(f) * 0.5
    st = (rng.standard_normal((b, h, c, c)).astype(f) * 0.1 if s0
          else np.zeros((b, h, c, c), f))
    return r, k, v, w_log, u, st


KERNEL_CHUNK, SUB = wkv6.KERNEL_CHUNK, 16


def serial_cumsum(x, restart):
    """fp32 cumulative sum over dim 2, added in series, from 0 every
    ``restart`` steps (the kernels' and torch.cumsum's order)."""
    out, acc = torch.empty_like(x), torch.zeros_like(x[:, :, 0])
    for i in range(x.shape[2]):
        acc = (acc if i % restart else torch.zeros_like(acc)) + x[:, :, i]
        out[:, :, i] = acc
    return out


def split_mirror(r, k, v, w_log, u, s0, *, chunk, frame=None,
                 exact_prev=False):
    """(out, s_T) by the CUDA kernels' decomposition, fp32, on the CPU.
    ``frame`` overrides ``cumsum_frame``; ``exact_prev`` takes lp_prev as
    the lp of the step before (0 at a frame's start) instead of
    lp - w_log. Neither is what the kernels do: they show what the
    kernels' choice is held against."""
    b, h, t, c = r.shape
    L = KERNEL_CHUNK
    n = -(-t // L)

    def pad(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, n * L - t))

    rr, kk, vv, ww = (pad(x).reshape(b, h, n, L, c) for x in (r, k, v, w_log))
    expn = lambda x: torch.exp(torch.clamp(x, max=0.0))
    # (a) each chunk's local state, lp from the chunk's start
    lpa = serial_cumsum(pad(w_log), L).reshape(b, h, n, L, c)
    lp_end = lpa[:, :, :, -1]
    ds = torch.einsum("bhnsc,bhnsd->bhncd", kk * expn(lp_end[:, :, :, None]
                                                      - lpa), vv)
    # (b) the scan over chunks from s0
    s, starts = s0.float(), []
    for j in range(n):
        starts.append(s)
        s = expn(lp_end[:, :, j])[..., None] * s + ds[:, :, j]
    # (c) lp over frames of one or two chunks; base: lp at the chunk's
    # start - 1 in its frame
    frame = frame or wkv6.cumsum_frame(t, chunk)
    lp = serial_cumsum(pad(w_log), frame)
    if exact_prev:
        lpp = torch.nn.functional.pad(lp[:, :, :-1], (0, 0, 1, 0))
        lpp[:, :, ::frame] = 0.0
        lpp = lpp.reshape(b, h, n, L, c)
    lp = lp.reshape(b, h, n, L, c)
    if not exact_prev:
        lpp = lp - ww
    base = torch.zeros_like(lp[:, :, :, :1])
    if frame == 2 * L:
        base[:, :, 1::2] = lp_end[:, :, 0:n - 1:2, None]
    out = torch.einsum("bhntc,bhncd->bhntd", rr * expn(lpp - base),
                       torch.stack(starts, dim=2))
    a = torch.zeros((b, h, n, L, L))
    half = SUB // 2
    tri = torch.tril(torch.ones((half, half), dtype=torch.bool), diagonal=-1)
    slack = 2.0 ** -23 * float(lp.abs().max())      # one rounding of lp

    def factorised(rows, cols, ref_row):
        """a[rows, cols] as (r e^{lp_prev - ref}) (k e^{ref - lp})^T."""
        ref = lp[:, :, :, ref_row:ref_row + 1]
        e_q, e_k = lpp[:, :, :, rows] - ref, ref - lp[:, :, :, cols]
        assert e_q.max() <= slack and e_k.max() <= 0
        a[:, :, :, rows, cols] = torch.einsum(
            "bhntc,bhnsc->bhnts", rr[:, :, :, rows] * expn(e_q),
            kk[:, :, :, cols] * expn(e_k))

    for j in range(L // SUB):
        s0_, s1_ = j * SUB, j * SUB + half
        if j:           # earlier sub-chunks, ref = lp_{start-1}
            factorised(slice(s0_, s0_ + SUB), slice(0, s0_), s0_ - 1)
        # the diagonal block's lower-left quadrant, ref = lp_{start+7}
        factorised(slice(s1_, s1_ + half), slice(s0_, s1_), s1_ - 1)
        for d in (s0_, s1_):     # two 8 x 8 diagonal blocks, pairwise
            rows = slice(d, d + half)
            dmat = expn(lpp[:, :, :, rows, None] - lp[:, :, :, None, rows])
            blk = torch.einsum("bhntc,bhnsc,bhntsc->bhnts",
                               rr[:, :, :, rows], kk[:, :, :, rows], dmat)
            bonus = torch.einsum("bhntc,hc,bhntc->bhnt", rr[:, :, :, rows],
                                 u.float(), kk[:, :, :, rows])
            a[:, :, :, rows, rows] = (torch.where(tri, blk, 0.0)
                                      + torch.diag_embed(bonus))
    out = out + a @ vv
    return out.reshape(b, h, n * L, c)[:, :, :t], s


def close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("t,chunk", [(64, 16), (96, 32), (50, 16), (7, 128)])
def test_plain_matches_recurrence_with_s0(t, chunk):
    """out and s_T against the naive recurrence, from a nonzero s0; T not a
    multiple of the chunk takes the zero-padded tail."""
    args = inputs(2, 3, t, 16, seed=t)
    want_o, want_s = jref.wkv6_ref(*map(jnp.asarray, args))
    got_o, got_s = wkv6.wkv6_plain(*map(torch.from_numpy, args), chunk=chunk)
    close(got_o, want_o, 2e-4)
    close(got_s, want_s, 2e-4)


@pytest.mark.parametrize("t,c", [(64, 16), (96, 8)])
def test_plain_matches_pallas_interpret(t, c):
    """Zero s0 (the Pallas kernel's only case), chunk 32."""
    r, k, v, w_log, u, _ = inputs(1, 2, t, c, seed=c, s0=False)
    want, _ = jops.wkv6(*map(jnp.asarray, (r, k, v, w_log, u)),
                        impl="interpret", chunk=32)
    got, _ = ops.wkv6(*map(torch.from_numpy, (r, k, v, w_log, u)), chunk=32)
    close(got, want, 2e-4)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("t,chunk", [(96, 32), (256, 128)])
def test_plain_matches_model_chunked(t, chunk, clip):
    args = inputs(1, 2, t, 16, seed=chunk, clip=clip)
    want_o, want_s = jrwkv.wkv6_chunked(*map(jnp.asarray, args), chunk=chunk)
    got_o, got_s = wkv6.wkv6_plain(*map(torch.from_numpy, args), chunk=chunk)
    close(got_o, want_o, 1e-5)
    close(got_s, want_s, 1e-5)
    assert np.isfinite(got_o.numpy()).all()


@pytest.mark.parametrize("b,h,t,c,chunk,clip,s0", [
    (1, 2, 256, 16, 128, True, True),   # w at the +4 clip, with s0
    (2, 3, 128, 64, 128, False, True),  # nonzero s0, C = 64
    (1, 2, 7, 16, 7, False, True),      # T below the sub-chunk
    (1, 2, 100, 64, 100, True, False),  # T off the chunk, clip, zero s0
    (2, 2, 192, 16, 64, False, True),   # C = 16, three chunks
], ids=["clip", "s0", "t_below_sub", "t_off_chunk", "c16"])
def test_split_mirror_matches_reference(b, h, t, c, chunk, clip, s0):
    """The kernels' decomposition against the reference's chunked form and
    its naive recurrence, with every factorised exponent <= 0."""
    args = inputs(b, h, t, c, seed=t + c, clip=clip, s0=s0)
    got_o, got_s = split_mirror(*map(torch.from_numpy, args), chunk=chunk)
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    jargs = list(map(jnp.asarray, args))
    for (want_o, want_s), rel in (
            (jrwkv.wkv6_chunked(*jargs, chunk=chunk), 1e-5),
            (jref.wkv6_ref(*jargs), 2e-4 if clip else 1e-5)):
        close(got_o, want_o, rel)
        close(got_s, want_s, rel)


@pytest.mark.parametrize("kw,lo,hi", [
    ({}, 0.0, 1e-5),
    (dict(frame=KERNEL_CHUNK), 1e-4, np.inf),
    (dict(exact_prev=True), 1e-4, np.inf),
], ids=["cumsum_frame", "frame_per_kernel_chunk", "exact_lp_prev"])
def test_cumsum_frame_holds_the_clip(kw, lo, hi):
    """Why the kernels sum lp over the plain version's blocks: at the +4
    clip, chunk 128, T 4096 (the rwkv6 prefill's chunk; the card check's
    clip case), the mirror with ``cumsum_frame`` and lp_prev = lp - w_log
    lies ~2e-7 of max|out| from ``wkv6_plain``. An lp restarted every
    kernel chunk, or an exact lp_prev, misses the card's 1e-4 (1.2e-4 to
    2.1e-4 over nine seeds at C 16 and 64): out's largest term, the
    adjacent step's, takes the plain version's rounding of lp - w_log."""
    args = list(map(torch.from_numpy,
                    inputs(1, 2, 4096, 64, seed=4160, clip=True)))
    want, _ = wkv6.wkv6_plain(*args, chunk=128)
    got, _ = split_mirror(*args, chunk=128, **kw)
    err = float((got - want).abs().max() / want.abs().max())
    assert lo < err <= hi, err


def test_chunk_sizes_match_the_source():
    """The wrapper sizes the kernels' scratch with KERNEL_CHUNK; the mirror
    takes SUB; the forward and backward kernels (csrc/wkv6.cu,
    csrc/wkv6_bwd.cu) take their L and SUB from csrc/wkv6_common.cuh."""
    csrc = Path(wkv6.__file__).parents[1] / "csrc"
    src = (csrc / "wkv6_common.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (L|SUB) = (\d+);", src))
    assert consts == {"L": str(KERNEL_CHUNK), "SUB": str(SUB)}
    for name in ("wkv6.cu", "wkv6_bwd.cu"):
        text = (csrc / name).read_text()
        assert '#include "wkv6_common.cuh"' in text
        assert not re.findall(r"constexpr int (L|SUB) = ", text)


@pytest.mark.parametrize("t,chunk,frame", [
    (4096, 128, 128), (300, 128, 128), (77, 128, 128), (100, 100, 128),
    (4096, 64, 64), (1000, 64, 64), (64, 128, 64), (40, 128, 64),
    (200, 48, 64), (1, 1, 64)])
def test_cumsum_frame_follows_the_plain_blocks(t, chunk, frame):
    """Two kernel chunks a frame where the plain version's blocks are 128
    steps or all of T > 64 steps, else one."""
    assert wkv6.cumsum_frame(t, chunk) == frame


def test_zero_s0_is_the_default():
    r, k, v, w_log, u, z = map(torch.from_numpy,
                               inputs(1, 2, 20, 16, seed=1, s0=False))
    o1, s1 = wkv6.wkv6(r, k, v, w_log, u, None, chunk=8)
    o2, s2 = wkv6.wkv6(r, k, v, w_log, u, z, chunk=8)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    args = list(map(torch.from_numpy, inputs(1, 2, 20, 16, seed=2)))
    before = wkv6.wkv6.launches
    out = wkv6.wkv6(*args, chunk=8)
    assert wkv6.wkv6.launches == before
    ref = wkv6.wkv6_plain(*args, chunk=8)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["chunk", "u", "s0"])
def test_wrapper_rejects_bad_arguments(bad):
    r, k, v, w_log, u, s0 = map(torch.from_numpy,
                                inputs(1, 2, 8, 16, seed=3))
    kw = dict(chunk=0 if bad == "chunk" else 8)
    if bad == "u":
        u = u[:, :8]
    if bad == "s0":
        s0 = s0[:, :1]
    with pytest.raises(ValueError):
        wkv6.wkv6(r, k, v, w_log, u, s0, **kw)
