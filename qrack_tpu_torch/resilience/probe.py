"""Device health probe (the port of the JAX package's
resilience/probe.py; the SIGTERM-first reaper is a copy).  Two halves:

* **child** (:func:`probe_payload` / ``--child``): initialises CUDA on
  ``cuda:0`` (``--device cpu`` probes the host instead, for the CPU
  tests), runs a small elementwise op and a 512x512 product, synchronises
  and prints ``PROBE_OK``.  The product is a liveness check of the
  device, not a kernel of the simulator.  This is the half that can hang
  on a wedged device, so it runs in a subprocess, never in the caller:
  ``python -m qrack_tpu_torch.resilience.probe --child``.
* **parent** (:func:`run_probe` / ``--watchdog``): spawns the child,
  waits ``timeout_s``, then escalates SIGTERM → (``term_grace_s``) →
  SIGKILL → bounded wait (:func:`reap_child`), so a child that ignores
  SIGTERM cannot outlive its watchdog and an unkillable one never blocks
  the caller.

The module is stdlib-only at import time; the child imports torch, and
the parent records `resilience.probe.ok/fail` events when the port's
telemetry is enabled (best-effort: the probe never depends on it).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

PROBE_OK_SENTINEL = "PROBE_OK"

DEFAULT_TIMEOUT_S = 120.0
DEFAULT_TERM_GRACE_S = 15.0
_KILL_WAIT_S = 10.0  # bounded wait after SIGKILL; never block forever

# the directory that holds the qrack_tpu_torch package (the child's
# import root)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# child half: the hang-prone payload
# ---------------------------------------------------------------------------

def probe_payload(device: str = "cuda", matmul_dim: int = 512) -> None:
    """Device init + tiny compute + a product, stdout line-buffered.
    Run ONLY under a watchdog (run_probe or an external `timeout`)."""
    t0 = time.time()
    import torch

    if device == "cuda":
        torch.cuda.init()
        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(dev)
    else:
        dev = torch.device("cpu")
        name = "cpu"
    print(f"PROBE device={name}", flush=True)
    x = torch.arange(16, dtype=torch.float32, device=dev)
    y = x * 2.0 + 1.0
    print(f"PROBE small_op_ok sum={float(y.sum())} t={time.time()-t0:.2f}s",
          flush=True)
    a = torch.ones((matmul_dim, matmul_dim), dtype=torch.float32, device=dev)
    b = torch.matmul(a, a)
    if device == "cuda":
        torch.cuda.synchronize(dev)
    print(f"PROBE matmul_ok val={float(b[0, 0])} t={time.time()-t0:.2f}s",
          flush=True)
    print(PROBE_OK_SENTINEL, flush=True)


def child_main(device: str = "cuda") -> int:
    probe_payload(device)
    return 0


# ---------------------------------------------------------------------------
# parent half: SIGTERM-first subprocess watchdog
# ---------------------------------------------------------------------------

@dataclass
class ProbeResult:
    ok: bool
    returncode: Optional[int]
    duration_s: float
    timed_out: bool = False
    killed: bool = False          # needed SIGKILL after the TERM grace
    output: str = ""
    command: List[str] = field(default_factory=list)

    def __bool__(self) -> bool:
        return self.ok


def _tele():
    """Best-effort telemetry handle; None when unavailable or off."""
    try:
        from qrack_tpu_torch import telemetry

        return telemetry if telemetry._ENABLED else None
    except Exception:
        return None


@dataclass
class ReapResult:
    killed: bool                   # needed SIGKILL after the TERM grace
    abandoned: bool                # survived even SIGKILL's bounded wait
    returncode: Optional[int]


def reap_child(proc, term_grace_s: float = DEFAULT_TERM_GRACE_S,
               kill_wait_s: float = _KILL_WAIT_S,
               wait=None) -> ReapResult:
    """SIGTERM-first child reaping with a bounded SIGKILL escalation:
    SIGTERM → wait ``term_grace_s`` → SIGKILL → wait ``kill_wait_s`` →
    abandon.  `wait` overrides how each bounded wait happens — it is
    called as ``wait(timeout_s)`` and must raise
    :class:`subprocess.TimeoutExpired` on expiry (run_probe passes a
    ``communicate`` closure so pipe output keeps draining); default is
    ``proc.wait``.  Never raises."""
    if wait is None:
        wait = proc.wait
    killed = abandoned = False
    try:
        proc.terminate()  # SIGTERM first
    except OSError:
        pass  # already gone
    try:
        wait(term_grace_s)
    except subprocess.TimeoutExpired:
        killed = True
        try:
            proc.kill()
        except OSError:
            pass
        try:
            wait(kill_wait_s)
        except subprocess.TimeoutExpired:
            abandoned = True  # unkillable child; abandon, stay bounded
    return ReapResult(killed=killed, abandoned=abandoned,
                      returncode=proc.returncode)


def run_probe(timeout_s: float = DEFAULT_TIMEOUT_S,
              term_grace_s: float = DEFAULT_TERM_GRACE_S,
              python: Optional[str] = None,
              extra_env: Optional[dict] = None,
              device: str = "cuda") -> ProbeResult:
    """Spawn the probe child (``python -m qrack_tpu_torch.resilience.probe
    --child --device <device>``) and watchdog it: SIGTERM at
    `timeout_s`, SIGKILL `term_grace_s` later, bounded wait after that.
    Never hangs the caller, never raises on an unhealthy device —
    inspect the returned :class:`ProbeResult`."""
    cmd = [python or sys.executable, "-m", "qrack_tpu_torch.resilience.probe",
           "--child", "--device", device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if extra_env:
        env.update(extra_env)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    timed_out = killed = False
    out = ""
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        timed_out = True
        collected = []

        def drain(t):
            collected[:] = [proc.communicate(timeout=t)[0]]

        reaped = reap_child(proc, term_grace_s=term_grace_s,
                            kill_wait_s=_KILL_WAIT_S, wait=drain)
        killed = reaped.killed
        out = "" if reaped.abandoned else (collected[0] if collected else "")
    duration = time.perf_counter() - t0
    ok = (not timed_out and proc.returncode == 0
          and PROBE_OK_SENTINEL in (out or ""))
    res = ProbeResult(ok=ok, returncode=proc.returncode, duration_s=duration,
                      timed_out=timed_out, killed=killed, output=out or "",
                      command=cmd)
    tele = _tele()
    if tele is not None:
        tele.event("resilience.probe.ok" if ok else "resilience.probe.fail",
                   duration_s=duration, timed_out=timed_out, killed=killed)
    return res


_PROBE_CACHE: Optional[ProbeResult] = None


def ensure_backend(timeout_s: float = DEFAULT_TIMEOUT_S,
                   refresh: bool = False) -> ProbeResult:
    """Once-per-process gate for in-process device init: probe the card
    from a subprocess first, so a wedged device is found by a killable
    child instead of hanging the caller.  Wired behind
    QRACK_TPU_PROBE_FIRST=1 (utils/device.py resolve_device)."""
    global _PROBE_CACHE
    if refresh or _PROBE_CACHE is None:
        _PROBE_CACHE = run_probe(timeout_s=timeout_s)
    return _PROBE_CACHE


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--child", action="store_true",
                      help="run the payload directly (no watchdog; the "
                           "caller must bound it)")
    mode.add_argument("--watchdog", action="store_true",
                      help="spawn the payload in a SIGTERM-first "
                           "watchdogged subprocess")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("--term-grace", type=float, default=DEFAULT_TERM_GRACE_S)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.watchdog:
        res = run_probe(timeout_s=args.timeout, term_grace_s=args.term_grace,
                        device=args.device)
        sys.stdout.write(res.output)
        if res.timed_out:
            print(f"PROBE_TIMEOUT after {args.timeout}s"
                  + (" (SIGKILL needed)" if res.killed else " (SIGTERM)"),
                  flush=True)
        return 0 if res.ok else 1
    # default (and --child): the payload itself
    return child_main(args.device)


if __name__ == "__main__":
    sys.exit(main())
