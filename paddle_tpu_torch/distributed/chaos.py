"""Crash points and fault injection at named sites (chaos harness).

Counterpart of ``paddle_tpu/distributed/chaos.py``. Every dangerous window
of the checkpoint save path is a named crash site
(``crashpoint("ckpt.shard_tmp_written")``) that a test arms through the
environment:

    PT_CRASHPOINT=ckpt.shard_tmp_written   # die the first time this site
                                           # is reached
    PT_CRASHPOINT_HITS=2                   # ... or only on the 2nd hit

An armed crash point kills the process with SIGKILL: no atexit handlers,
no flushing, no cleanup, as a preemption or an OOM kill. Sites register
themselves at import (``register``), so the crash matrix enumerates them
with ``registered_sites(prefix)``.

A registered fault site sits on a blocking primitive's hot path and can
be armed with one of four modes:

    PT_FAULTPOINT=engine.pressure      # the armed site
    PT_FAULTPOINT_MODE=delay:2.5       # crash | delay:<secs> | error | drop
    PT_FAULTPOINT_HITS=1               # fire on this many hits, then disarm
                                       # (0 or 'inf' = every hit)
    PT_FAULTPOINT_SKIP=2               # let the first N hits pass clean

Unarmed sites cost one dict lookup plus one getenv.
"""
from __future__ import annotations

import os
import signal
import time

__all__ = ["register", "registered_sites", "describe", "crashpoint",
           "FaultInjected", "FaultDrop", "register_fault", "fault_sites",
           "describe_fault", "faultpoint", "reset_hits"]

# crash site name -> short description of the window it guards
_REGISTRY: dict[str, str] = {}
_hits: dict[str, int] = {}


def register(site: str, description: str = "") -> str:
    """Declare a crash site (idempotent); returns the site name."""
    _REGISTRY.setdefault(site, description)
    return site


def registered_sites(prefix: str = "") -> list[str]:
    """Every declared crash site starting with ``prefix``, sorted."""
    return sorted(s for s in _REGISTRY if s.startswith(prefix))


def describe(site: str) -> str:
    return _REGISTRY.get(site, "")


def crashpoint(site: str) -> None:
    """Die here (SIGKILL) iff this site is armed via PT_CRASHPOINT, on the
    PT_CRASHPOINT_HITS-th time it is reached (default the first)."""
    if site not in _REGISTRY:
        register(site)
    if os.environ.get("PT_CRASHPOINT") != site:
        return
    _hits[site] = _hits.get(site, 0) + 1
    if _hits[site] < int(os.environ.get("PT_CRASHPOINT_HITS", "1") or 1):
        return
    os.kill(os.getpid(), signal.SIGKILL)


class FaultInjected(RuntimeError):
    """An armed ``error``-mode faultpoint fired."""

    def __init__(self, site: str, mode: str = "error"):
        self.site = site
        self.mode = mode
        super().__init__(f"injected fault at {site!r} (mode={mode})")


class FaultDrop(FaultInjected, ConnectionError):
    """An armed ``drop``-mode faultpoint fired: the wire died mid-operation."""

    def __init__(self, site: str):
        super().__init__(site, mode="drop")


# fault site name -> short description of the window it guards
_FAULTS: dict[str, str] = {}
_fault_hits: dict[str, int] = {}


def register_fault(site: str, description: str = "") -> str:
    """Declare a fault site (idempotent); returns the site name."""
    _FAULTS.setdefault(site, description)
    return site


def fault_sites(prefix: str = "") -> list[str]:
    """Every declared fault site starting with ``prefix``, sorted."""
    return sorted(s for s in _FAULTS if s.startswith(prefix))


def describe_fault(site: str) -> str:
    return _FAULTS.get(site, "")


def reset_hits() -> None:
    """Forget hit counts (tests that arm several sites in one process)."""
    _hits.clear()
    _fault_hits.clear()


def _fault_should_fire(site: str) -> bool:
    """Skip the first PT_FAULTPOINT_SKIP hits, then fire PT_FAULTPOINT_HITS
    times (default 1; 0/'inf' = forever)."""
    _fault_hits[site] = _fault_hits.get(site, 0) + 1
    hit = _fault_hits[site]
    skip = int(os.environ.get("PT_FAULTPOINT_SKIP", "0") or 0)
    if hit <= skip:
        return False
    raw = os.environ.get("PT_FAULTPOINT_HITS", "1") or "1"
    if raw.lower() in ("0", "inf"):
        return True
    return hit - skip <= int(raw)


def faultpoint(site: str) -> None:
    """Inject the armed fault mode here iff this site is armed via
    PT_FAULTPOINT."""
    if site not in _FAULTS:
        register_fault(site)
    if os.environ.get("PT_FAULTPOINT") != site:
        return
    if not _fault_should_fire(site):
        return
    mode = os.environ.get("PT_FAULTPOINT_MODE", "error").strip()
    from ..observability.trace import event
    event(site, cat="chaos.fault", mode=mode)
    if mode == "crash":
        os.kill(os.getpid(), signal.SIGKILL)
    if mode.startswith("delay"):
        _, _, secs = mode.partition(":")
        time.sleep(float(secs or 1.0))
        return
    if mode == "drop":
        raise FaultDrop(site)
    raise FaultInjected(site)
