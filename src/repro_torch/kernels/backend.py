"""Device and kernel-backend resolution of the port.

Counterpart of ``src/repro/kernels/backend.py``. The port's request axis
is ``KERNEL_BACKENDS = auto | torch | cuda``:

  auto   ``cuda`` on a CUDA device, ``torch`` on a CPU device;
  torch  the plain PyTorch versions; CPU only, raises on a CUDA device;
  cuda   the hand-written CUDA kernels; CUDA only, raises on a CPU device.

The request only validates and probes: the kernel wrappers themselves
pick the plain version for CPU tensors and the kernel for CUDA tensors.
Resolving to ``cuda`` runs the probe kernel once per process
(``functools.lru_cache``): it builds the kernel library and checks that
``x + 1`` comes back from the card. A failed build or a wrong answer
raises. There is no fallback: on a CUDA device a kernel either runs or the
call fails.

``resolve_device`` is the one place the port turns a ``device`` argument
into a ``torch.device``. Entry points default to ``"cuda"``; asking for it
on a host without a card raises instead of running on the CPU, unless a
``FakeTensorMode`` is active (the dry run's fake card, where nothing
runs).
"""
from __future__ import annotations

import functools

import torch
from torch._guards import detect_fake_mode

from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.kernels import build


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument. CUDA
    without a visible card raises, except under an active
    ``FakeTensorMode``; only an explicit CPU runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            if detect_fake_mode() is not None:
                # a fake trace (launch/dryrun.py): no card is touched
                return torch.device("cuda", dev.index or 0)
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' explicitly to run the plain PyTorch versions "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def probe_kernel(x: torch.Tensor) -> torch.Tensor:
    """Wrapper of the CUDA probe kernel: ``x + 1`` for a CUDA fp32 tensor;
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return probe_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("probe_kernel takes a non-empty contiguous fp32 "
                         "tensor")
    y = torch.empty_like(x)
    lib = build.load()
    code = lib.repro_probe(x.data_ptr(), y.data_ptr(), x.numel(),
                           x.device.index,
                           torch.cuda.current_stream(x.device).cuda_stream)
    build.count_launch(probe_kernel)
    build.check(code, "probe_kernel")
    return y


probe_kernel.launches = 0


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


@functools.lru_cache(maxsize=None)
def probe(device: torch.device) -> None:
    """Build the kernels and run the probe once per process and device;
    raise if the card does not return ``x + 1``."""
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=device).reshape(8, 128)
    y = probe_kernel(x)
    torch.cuda.synchronize(device)
    if not torch.equal(y, x + 1.0):
        raise RuntimeError("CUDA probe kernel returned a wrong result")


def resolve_backend(kernel_backend: str = "auto",
                    device="cuda") -> torch.device:
    """Check a ``KERNEL_BACKENDS`` request against ``device`` and return
    the resolved ``torch.device``; on a CUDA device run the probe (raises
    on failure)."""
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel_backend {kernel_backend!r} "
                         f"(expected one of {KERNEL_BACKENDS})")
    if kernel_backend == "torch" and torch.device(device).type == "cuda":
        raise RuntimeError("kernel_backend='torch' runs only on the CPU; "
                           "on a CUDA device the kernels run (pass "
                           "device='cpu' for the plain PyTorch versions)")
    dev = resolve_device(device)
    if dev.type == "cpu":
        if kernel_backend == "cuda":
            raise RuntimeError("kernel_backend='cuda' needs a CUDA device, "
                             "got device='cpu'")
        return dev
    probe(dev)
    return dev
