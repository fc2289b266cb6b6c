"""The device every entry point of the package defaults to."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device of an engine or a ket: ``cuda`` by default, which must
    exist.  The CPU only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qrack_tpu_torch runs on a CUDA device; pass device='cpu' to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def discover(device=None) -> torch.device:
    """:func:`resolve_device` at an engine's construction (guarded site
    ``discover``, the JAX engine's backend init).  With the resilience
    plane armed it is breaker-gated and retried and, under
    ``QRACK_TPU_PROBE_FIRST=1``, preceded by a SIGTERM-first subprocess
    probe of the card (resilience/probe.py), so a wedged device is found
    by a killable child instead of this process."""
    from .. import resilience as _res

    if not _res._ACTIVE:
        return resolve_device(device)
    if os.environ.get("QRACK_TPU_PROBE_FIRST", "") not in ("", "0") and (
            device is None or torch.device(device).type == "cuda"):
        from ..resilience import probe as _probe
        from ..resilience.errors import DispatchGiveUp, DispatchTimeout

        r = _probe.ensure_backend()
        if not r.ok:
            _res.get_breaker().record_failure("discover")
            raise DispatchGiveUp(
                "discover", DispatchTimeout("discover", detail="probe failed"))
    return _res.call_guarded("discover", resolve_device, (device,))
