"""JSONL run ledger: every experiment run leaves a reproducible trail.

Copy of ``RunLedger`` from ``src/repro/obs/ledger.py``, with the same
``MANIFEST_KEYS``, ``EVENT_KEYS``, directory naming and gates. A
``RunLedger`` owns one directory under ``experiments/runs/`` (override
with ``REPRO_RUNS_DIR``) named ``<utc-stamp>_<kind>_<pid>`` holding:

* ``manifest.json``, written at open: run kind, config dict, git sha,
  torch's backend (``"cuda"`` or ``"cpu"``) and device names, the python,
  numpy and torch versions, argv;
* ``events.jsonl``, one JSON object a line, appended as the run goes:
  ``{"event": <type>, "t_wall_s": <since open>, ...payload}``, flushed per
  line so a crashed run still leaves a readable prefix.

``REPRO_LEDGER=0`` disables ledgers: ``RunLedger.open(...)`` then returns
a shared no-op ledger, so call sites never branch.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from .metrics import json_safe

__all__ = ["RunLedger", "ledger_enabled", "runs_root", "git_sha"]

# Required manifest keys (DESIGN.md section 11).
MANIFEST_KEYS = ("kind", "created_utc", "config", "git_sha", "backend",
                 "devices", "versions", "argv")
# Required per-event keys (payload keys ride alongside).
EVENT_KEYS = ("event", "t_wall_s")


def ledger_enabled() -> bool:
    return os.environ.get("REPRO_LEDGER", "1") not in ("0", "false", "off")


def runs_root() -> Path:
    return Path(os.environ.get("REPRO_RUNS_DIR", "experiments/runs"))


@functools.lru_cache(maxsize=1)
def git_sha() -> Optional[str]:
    """Current commit sha (cached; None outside a git checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:  # pragma: no cover - git missing entirely
        return None


def _environment() -> dict:
    """Backend/device/version facts for the manifest: ``"cuda"`` with the
    name of every visible card, else ``"cpu"``."""
    import numpy
    import torch
    env: dict = {"backend": "cpu", "devices": ["cpu"], "versions": {
        "python": sys.version.split()[0], "numpy": numpy.__version__,
        "torch": torch.__version__}}
    if torch.cuda.is_available():
        env["backend"] = "cuda"
        env["devices"] = [torch.cuda.get_device_name(i)
                          for i in range(torch.cuda.device_count())]
        env["versions"]["cuda"] = torch.version.cuda
    return env


class RunLedger:
    """One run's manifest + JSONL event stream.

    Construct via ``RunLedger.open(kind, config)`` (returns the shared
    no-op instance when disabled). Usable as a context manager; ``close``
    emits a final ``run_end`` event.
    """

    def __init__(self, run_dir: Optional[Path]):
        self.run_dir = run_dir
        self._fh = None
        self._t0 = time.perf_counter()

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def open(cls, kind: str, config: Optional[dict] = None, *,
             root: Optional[str] = None,
             enabled: Optional[bool] = None) -> "RunLedger":
        """Create the run directory and write the manifest. ``enabled``
        / ``root`` override the REPRO_LEDGER / REPRO_RUNS_DIR env gates
        (tests pass them explicitly)."""
        if enabled is None:
            enabled = ledger_enabled()
        if not enabled:
            return _NULL_LEDGER
        base = Path(root) if root is not None else runs_root()
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        run_dir = base / f"{stamp}_{kind}_{os.getpid()}"
        i = 0
        while run_dir.exists():  # same-second collision within one pid
            i += 1
            run_dir = base / f"{stamp}_{kind}_{os.getpid()}_{i}"
        run_dir.mkdir(parents=True)
        led = cls(run_dir)
        env = _environment()
        manifest = {
            "kind": kind,
            "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
            "config": json_safe(config or {}),
            "git_sha": git_sha(),
            "backend": env["backend"],
            "devices": env["devices"],
            "versions": env["versions"],
            "argv": list(sys.argv),
        }
        with open(run_dir / "manifest.json", "w") as fh:
            json.dump(manifest, fh, indent=2, allow_nan=False)
            fh.write("\n")
        led._fh = open(run_dir / "events.jsonl", "a")
        led.event("run_start", kind=kind)
        return led

    @property
    def enabled(self) -> bool:
        return self.run_dir is not None

    def close(self) -> None:
        if self._fh is not None:
            self.event("run_end")
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "RunLedger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- emission -----------------------------------------------------------

    def event(self, event: str, **payload) -> None:
        """Append one event line (no-op when disabled). Payload values go
        through ``json_safe`` so ndarray/NaN leaves cannot corrupt the
        stream; the line is flushed immediately."""
        if self._fh is None:
            return
        rec = {"event": event,
               "t_wall_s": round(time.perf_counter() - self._t0, 6)}
        rec.update(json_safe(payload))
        json.dump(rec, self._fh, allow_nan=False)
        self._fh.write("\n")
        self._fh.flush()


_NULL_LEDGER = RunLedger(None)
