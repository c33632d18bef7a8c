"""Storage tiers: device-residency management for segments.

The port's copy of ``diagon_tpu/observability/storage_tiers.py``, the
equivalent of the reference's storage-tier subsystem
(``storage/StorageTier.h``, ``TierManager.h``, ``LifecyclePolicy.h``,
``TierMigrationService.h`` -- SURVEY.md section 2.10), cast for one CUDA
card: the tiers are DEVICE (tensors in the card's memory, searchable at
full speed), HOST (numpy SegmentData in RAM, searchable by the oracle
path), and DISK (``.bnd`` files, must be read before use). The manager
enforces a device byte budget (``hbm_budget``, the name callers read) with
LRU eviction and applies lifecycle policies (e.g. demote segments not
queried for N seconds). The same sequence of calls makes the same
decisions as the JAX package's manager.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional


class StorageTier(enum.Enum):
    DEVICE = "device"  # in the card's memory (hot)
    HOST = "host"  # numpy in RAM (warm)
    DISK = "disk"  # .bnd file only (cold)


@dataclass
class TierEntry:
    name: str
    tier: StorageTier
    bytes_device: int = 0
    bytes_host: int = 0
    last_access: float = dc_field(default_factory=time.monotonic)
    pinned: bool = False


@dataclass
class LifecyclePolicy:
    """Age-based demotion thresholds (seconds since last access)."""

    demote_to_host_after: Optional[float] = None
    demote_to_disk_after: Optional[float] = None


class TierManager:
    """Tracks per-segment residency against a device byte budget.

    The manager is advisory: it decides moves; callers execute them via the
    provided callbacks (load to device / drop device arrays / drop host
    copy), keeping the manager free of engine dependencies.
    """

    def __init__(
        self,
        hbm_budget_bytes: int,
        promote: Optional[Callable[[str], int]] = None,
        demote_to_host: Optional[Callable[[str], None]] = None,
        demote_to_disk: Optional[Callable[[str], None]] = None,
        policy: Optional[LifecyclePolicy] = None,
    ):
        self.hbm_budget = hbm_budget_bytes
        self._entries: Dict[str, TierEntry] = {}
        self._promote = promote
        self._demote_host = demote_to_host
        self._demote_disk = demote_to_disk
        self.policy = policy or LifecyclePolicy()

    # -- bookkeeping -------------------------------------------------------
    def register(self, name: str, tier: StorageTier,
                 bytes_device: int = 0, bytes_host: int = 0,
                 pinned: bool = False) -> None:
        self._entries[name] = TierEntry(
            name, tier, bytes_device, bytes_host, pinned=pinned
        )

    def touch(self, name: str) -> None:
        e = self._entries.get(name)
        if e is not None:
            e.last_access = time.monotonic()

    def device_bytes(self) -> int:
        return sum(
            e.bytes_device
            for e in self._entries.values()
            if e.tier == StorageTier.DEVICE
        )

    def tier_of(self, name: str) -> Optional[StorageTier]:
        e = self._entries.get(name)
        return e.tier if e else None

    # -- decisions ---------------------------------------------------------
    def ensure_device(self, name: str) -> List[str]:
        """Promote a segment to DEVICE, evicting LRU segments if the budget
        would be exceeded. Returns the names evicted."""
        e = self._entries[name]
        self.touch(name)
        evicted: List[str] = []
        if e.tier == StorageTier.DEVICE:
            return evicted
        needed = e.bytes_device
        while (
            self.device_bytes() + needed > self.hbm_budget
            and self._evict_one(exclude=name, out=evicted)
        ):
            pass
        if self.device_bytes() + needed > self.hbm_budget:
            raise MemoryError(
                f"cannot fit segment {name!r} ({needed} B) in the device budget "
                f"{self.hbm_budget} B"
            )
        if self._promote is not None:
            e.bytes_device = self._promote(name) or needed
        e.tier = StorageTier.DEVICE
        return evicted

    def _evict_one(self, exclude: str, out: List[str]) -> bool:
        candidates = [
            e
            for e in self._entries.values()
            if e.tier == StorageTier.DEVICE
            and not e.pinned
            and e.name != exclude
        ]
        if not candidates:
            return False
        victim = min(candidates, key=lambda e: e.last_access)
        if self._demote_host is not None:
            self._demote_host(victim.name)
        victim.tier = StorageTier.HOST
        out.append(victim.name)
        return True

    def apply_lifecycle(self) -> Dict[str, StorageTier]:
        """Run the age policy; returns {segment: new tier} for moved ones."""
        now = time.monotonic()
        moved: Dict[str, StorageTier] = {}
        p = self.policy
        for e in self._entries.values():
            if e.pinned:
                continue
            age = now - e.last_access
            if (
                e.tier == StorageTier.DEVICE
                and p.demote_to_host_after is not None
                and age > p.demote_to_host_after
            ):
                if self._demote_host is not None:
                    self._demote_host(e.name)
                e.tier = StorageTier.HOST
                moved[e.name] = e.tier
                continue  # one tier step per pass
            if (
                e.tier == StorageTier.HOST
                and p.demote_to_disk_after is not None
                and age > p.demote_to_disk_after
            ):
                if self._demote_disk is not None:
                    self._demote_disk(e.name)
                e.tier = StorageTier.DISK
                moved[e.name] = e.tier
        return moved

    def stats(self) -> Dict[str, dict]:
        return {
            e.name: {
                "tier": e.tier.value,
                "bytes_device": e.bytes_device,
                "age_s": time.monotonic() - e.last_access,
                "pinned": e.pinned,
            }
            for e in self._entries.values()
        }
