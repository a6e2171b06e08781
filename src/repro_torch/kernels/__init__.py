"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper carries a plain int ``launches`` that it increments where it
launches its kernel, and nowhere else; ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0. ``swa_bwd`` and ``wkv6_bwd`` are
the backward kernels that autograd reaches through ``swa`` and ``wkv6``
on the card.
"""
from repro_torch.kernels import backend as _backend
from repro_torch.kernels import fedagg as _fedagg
from repro_torch.kernels import pairscore as _pairscore
from repro_torch.kernels import planner as _planner
from repro_torch.kernels import swa as _swa
from repro_torch.kernels import wkv6 as _wkv6

WRAPPERS = {"probe_kernel": _backend.probe_kernel,
            "pairscore": _pairscore.pairscore,
            "fedagg": _fedagg.fedagg,
            "planner": _planner.planner_tables,
            "swa": _swa.swa,
            "wkv6": _wkv6.wkv6,
            "swa_bwd": _swa.swa_bwd,
            "wkv6_bwd": _wkv6.wkv6_bwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
