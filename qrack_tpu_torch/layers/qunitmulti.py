"""QUnitMulti: QUnit with capability-aware per-subsystem device placement
(counterpart of the JAX package's layers/qunitmulti.py).

Re-design of the reference layer (reference: include/qunitmulti.hpp:66;
src/qunitmulti.cpp — each separable subsystem is a whole engine placed
on one device; RedistributeQEngines greedily re-packs the biggest
subsystems onto the most capable devices after every entangle/separate
event :138-166,217; device capability table DeviceInfo
include/qunitmulti.hpp:55; per-device max-alloc guard
src/common/oclengine.cpp:388; env QRACK_QUNITMULTI_DEVICES
src/qunitmulti.cpp:72-117).

Here a "device" is a CUDA ordinal, meaningful where a unit can move (the
"cuda" engine and QHybrid over it take SetDevice; the host oracle and
the layers above an engine ignore placement, as in the JAX package).
The device list may name one card more than once: each entry is a row
of its own, with its own byte accounting.  Each row carries a ket-byte
budget (the card's memory over MEM_DENOM, else QRACK_QUNITMULTI_MAX_QB /
QRACK_MAX_ALLOC_MB) and a capability weight.  Redistribution is greedy
best fit: subsystems size-descending onto the row with the most
remaining weighted capacity, so two large subsystems land on different
rows, and a subsystem no row can hold raises MemoryError up front
instead of letting the card run out of memory mid-gate.

Under a cluster (parallel/cluster.py) a unit's ket lives in one
process: the device table lists this process's devices only (the
``local_device_ids`` it was brought up with), and a device id of another
process raises (the JAX package's table is ``jax.devices()``, global,
but a unit cannot be placed on a device this process cannot address).

Each redistribution counts ``qunitmulti.redistribute`` in telemetry, as
in the JAX package.  Checkpoints take QUnit's structured capture (kind
``"unit_multi"``); a restore places every restored unit on the row this
layer's redistribution gives it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from .. import telemetry as _tele
from .qunit import QUnit

# The reference caps one ket at device memory / 3 (OclMemDenom,
# include/qengine_opencl.hpp:279): gate application transiently holds
# input + output + workspace.
MEM_DENOM = 3


@dataclass
class DeviceInfo:
    """Capability row (reference: include/qunitmulti.hpp:55)."""

    device_id: int
    capacity_bytes: int = 0      # ket budget; 0 = unguarded
    weight: float = 1.0          # relative throughput
    used_bytes: int = 0          # accounted ket bytes placed on this row

    def free_bytes(self) -> float:
        if self.capacity_bytes <= 0:
            return float("inf")
        return self.capacity_bytes - self.used_bytes


def _cuda_ids() -> List[int]:
    return list(range(torch.cuda.device_count())) if torch.cuda.is_available() else []


def _discover_capacity(device_id: int) -> int:
    """A row's ket budget in bytes: the card's memory over MEM_DENOM
    when the ordinal names a card, else the environment, else
    unguarded."""
    if device_id in _cuda_ids():
        try:
            total = int(torch.cuda.mem_get_info(device_id)[1])
        except RuntimeError:
            total = int(torch.cuda.get_device_properties(device_id).total_memory)
        if total > 0:
            return total // MEM_DENOM
    max_qb = int(os.environ.get("QRACK_QUNITMULTI_MAX_QB", "0"))
    if max_qb > 0:
        return 2 * (1 << max_qb) * 4  # float32 planes
    max_mb = int(os.environ.get("QRACK_MAX_ALLOC_MB", "0"))
    if max_mb > 0:
        return max_mb << 20
    return 0


def _unit_bytes(unit) -> int:
    """Steady-state ket bytes of one subsystem engine."""
    n = unit.qubit_count
    dtype = getattr(unit, "dtype", None)
    if dtype is not None:
        return 2 * (1 << n) * dtype.itemsize  # split real/imag planes
    return (1 << n) * 16  # complex128 oracle


class QUnitMulti(QUnit):
    def __init__(self, qubit_count: int, init_state: int = 0,
                 device_ids: Optional[Sequence[int]] = None,
                 device_table: Optional[Sequence[DeviceInfo]] = None,
                 **kwargs):
        super().__init__(qubit_count, init_state=init_state, **kwargs)
        if device_table is not None:
            self.devices = list(device_table)
        else:
            self.devices = self._build_device_table(device_ids)

    @staticmethod
    def _build_device_table(device_ids: Optional[Sequence[int]]) -> List[DeviceInfo]:
        from ..parallel import cluster

        env_ids = os.environ.get("QRACK_QUNITMULTI_DEVICES", "")
        if device_ids is None and env_ids:
            device_ids = [int(t) for t in env_ids.split(",") if t.strip()]
        local = cluster.local_device_ids()
        if device_ids is None:
            device_ids = local or _cuda_ids() or [0]
        elif local is not None:
            foreign = [i for i in device_ids if i not in local]
            if foreign:
                raise ValueError(
                    f"QUnitMulti device ids {foreign} belong to no card of "
                    f"this process (its cards: {local}); a unit's ket lives "
                    "in one process")
        # capability weights: QRACK_QUNITMULTI_WEIGHTS=1.0,4.0 (the k-th
        # token to the k-th SELECTED row) or 0=1.0,3=4.0 (id=weight;
        # unlisted ids 1.0); mixed forms are an error
        weights, wmap = QUnitMulti._parse_weights(
            os.environ.get("QRACK_QUNITMULTI_WEIGHTS", ""))
        table = [
            DeviceInfo(device_id=i, capacity_bytes=_discover_capacity(i),
                       weight=(wmap.get(i, 1.0) if wmap is not None
                               else (weights[k] if k < len(weights) else 1.0)))
            for k, i in enumerate(device_ids)
        ]
        unguarded = [d.device_id for d in table if d.capacity_bytes <= 0]
        if unguarded:
            import warnings

            warnings.warn(
                f"QUnitMulti devices {unguarded} have no discoverable "
                "memory budget (no CUDA device, no QRACK_QUNITMULTI_MAX_QB"
                "/QRACK_MAX_ALLOC_MB): the up-front allocation guard is "
                "DISABLED for them and oversized subsystems will surface "
                "as runtime OOM instead of MemoryError",
                RuntimeWarning, stacklevel=3)
        return table

    @staticmethod
    def _parse_weights(wenv: str):
        """Parse QRACK_QUNITMULTI_WEIGHTS.  Returns (positional, wmap):
        the positional list for the bare ``1.0,4.0`` form (wmap None),
        the id-keyed dict for ``0=1.0,3=4.0`` (positional empty).
        Mixing forms raises ValueError."""
        tokens = [t.strip() for t in wenv.split(",") if t.strip()]
        if not tokens:
            return [], None
        paired = [t for t in tokens if "=" in t]
        if paired and len(paired) != len(tokens):
            raise ValueError(
                "QRACK_QUNITMULTI_WEIGHTS mixes positional and id=weight "
                f"tokens: {wenv!r} — use one form")
        if paired:
            wmap: Dict[int, float] = {}
            for t in tokens:
                k, _, v = t.partition("=")
                wmap[int(k)] = float(v)
            return [], wmap
        return [float(t) for t in tokens], None

    def MeasureDeviceWeights(self, size: int = 1024, reps: int = 3) -> None:
        """Capability weights from a live throughput probe (reference:
        the 'most capable device' ordering, src/qunitmulti.cpp:217): a
        small matmul on each card, timed with CUDA events; weight =
        fastest / this card's best time.  Rows that name no card keep
        their weight."""
        times = {}
        for info in self.devices:
            i = info.device_id
            if i not in _cuda_ids() or i in times:
                continue
            dev = torch.device("cuda", i)
            x = torch.ones((size, size), dtype=torch.float32, device=dev)
            (x @ x).sum().item()  # warm
            best = float("inf")
            with torch.cuda.device(dev):
                for _ in range(reps):
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    x @ x
                    t1.record()
                    t1.synchronize()
                    best = min(best, t0.elapsed_time(t1) * 1e-3)
            times[i] = best
        if not times:
            return
        fastest = min(times.values())
        for info in self.devices:
            if info.device_id in times:
                t = times[info.device_id]
                info.weight = fastest / t if t > 0 else 1.0
        self.RedistributeQEngines()

    # -- device table surface (reference: SetDeviceList/GetDeviceList) --

    def SetDeviceList(self, device_ids: Sequence[int]) -> None:
        self.devices = self._build_device_table(list(device_ids))
        self.RedistributeQEngines()

    def GetDeviceList(self) -> List[int]:
        return [d.device_id for d in self.devices]

    @property
    def device_ids(self) -> List[int]:
        return self.GetDeviceList()

    # -- placement ------------------------------------------------------

    def _to_unit(self, q: int):
        fresh = self.shards[q].unit is None
        unit = super()._to_unit(q)
        if fresh and hasattr(unit, "SetDevice"):
            dev = self._best_device(_unit_bytes(unit))
            dev.used_bytes += _unit_bytes(unit)
            unit.SetDevice(dev.device_id)
        return unit

    def _merge(self, qubits):
        unit = super()._merge(qubits)
        self.RedistributeQEngines()
        return unit

    def _detach_raw(self, q: int, collapsed_val: bool, base_vec) -> None:
        super()._detach_raw(q, collapsed_val, base_vec)
        self.RedistributeQEngines()

    def _capability_order(self) -> List[DeviceInfo]:
        """Rows most-capable-first: weight, then budget (unguarded sorts
        as largest)."""
        return sorted(
            self.devices,
            key=lambda d: (-d.weight,
                           -(d.capacity_bytes if d.capacity_bytes > 0
                             else 2 ** 62)))

    def _best_device(self, need_bytes: int) -> DeviceInfo:
        """Most free capacity (weight-preferred) among rows that can hold
        `need_bytes`; MemoryError if none can (the alloc guard).  Used
        for fresh single-qubit units, where spread matters more than
        capability: unguarded rows all report infinite free bytes, so
        the accounted bytes break their tie."""
        fits = [d for d in self.devices
                if d.capacity_bytes <= 0 or d.free_bytes() >= need_bytes]
        if not fits:
            self._raise_no_fit(need_bytes)
        return max(fits, key=lambda d: (
            d.free_bytes(),
            -d.used_bytes if d.capacity_bytes <= 0 else 0,
            d.weight,
            -d.used_bytes))

    def _raise_no_fit(self, need_bytes: int) -> None:
        cap = max((d.capacity_bytes for d in self.devices), default=0)
        raise MemoryError(
            f"no device can hold a {need_bytes}-byte subsystem ket "
            f"(largest per-device budget {cap} bytes; "
            "QRACK_QUNITMULTI_MAX_QB / QRACK_MAX_ALLOC_MB)")

    def RedistributeQEngines(self) -> None:
        """Pairwise greedy re-pack: subsystems size-descending onto rows
        most-capable-first with wraparound, skipping rows whose byte
        budget the subsystem exceeds (reference: src/qunitmulti.cpp:217;
        the byte accounting here also guards allocation up front)."""
        units = []
        seen = set()
        for s in self.shards:
            if s.unit is not None and id(s.unit) not in seen:
                seen.add(id(s.unit))
                units.append(s.unit)
        units.sort(key=lambda u: -u.qubit_count)
        if _tele._ENABLED:
            _tele.inc("qunitmulti.redistribute")
        order = self._capability_order()
        for d in self.devices:
            d.used_bytes = 0
        for i, u in enumerate(units):
            need = _unit_bytes(u)
            for k in range(len(order)):
                d = order[(i + k) % len(order)]
                if d.capacity_bytes <= 0 or d.free_bytes() >= need:
                    d.used_bytes += need
                    if hasattr(u, "SetDevice"):
                        u.SetDevice(d.device_id)
                    break
            else:
                self._raise_no_fit(need)

    # checkpoint protocol: QUnit's structured capture/restore, then the
    # restored units are placed on this layer's device rows
    _ckpt_kind = "unit_multi"

    def _ckpt_restore(self, arrays, meta, children, restore_child):
        super()._ckpt_restore(arrays, meta, children, restore_child)
        self.RedistributeQEngines()
