"""Device/resource layer: capabilities probe, mesh, compiled-program cache.

Rebuild of the reference's L1 resource layer:
  * ``TpuDeviceCapabilities`` ≈ MetalDeviceCapabilities
    (include/faiss-metal/MetalDeviceCapabilities.h:23-65 — runtime hardware
    detection driving kernel selection). Here it records the platform, the
    device kind, how Pallas kernels run there (``kernel_mode``) and the
    per-kind tuning from ``_KIND_TUNING``.
  * ``TpuResources`` ≈ MetalResources/StandardMetalResources
    (include/faiss-metal/MetalResources.h:38-54,
    src/StandardMetalResources.mm:10-45): owns the devices, the 1-D mesh used
    for database sharding, and the compiled-function cache. The reference's
    pipeline-state-object construction at index creation corresponds to jit
    trace/compile warm-up here; its MTLResidencySet pre-paging is automatic
    (device arrays live in device memory).
  * ``describe_capabilities`` ≈ describeCapabilities()
    (src/MetalDeviceCapabilities.mm:98-124) — the observability hook.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np


@dataclasses.dataclass(frozen=True)
class KernelTuning:
    """Per-device-kind tuning (the reference selects among its pipeline
    states by generation, MetalDistance.mm:11-103)."""

    # nv chunk size of the plain path's two-stage (chunked) top-k and of
    # range_search's column blocks.
    chunk_v: int = 256 * 1024
    # where the values come from (a measurement with its card, or "test")
    source: str = "default"


# Keyed by jax.Device.device_kind. A GPU kind missing here raises: another
# card's values are not this card's.
_KIND_TUNING = {
    # plain bf16 search at 10M×128, nq=100 (PERF.md): 64K 85.0 ms, 256K
    # 71.3, 1M 64.3, 2M 66.3 (H100 80GB HBM3 at a 400 W power limit)
    "NVIDIA H100 80GB HBM3": KernelTuning(
        chunk_v=1024 * 1024, source="H100 plain-path chunk_v sweep"),
    # the test platform: small chunks keep interpret-mode programs cheap
    "cpu": KernelTuning(chunk_v=64 * 1024, source="test"),
}

# platform -> how Pallas kernels run there
_KERNEL_MODE = {"gpu": "compiled", "cpu": "interpret"}


def kernel_mode_for(platform: str) -> str:
    """"compiled" on the GPU (the Triton route), "interpret" on the CPU test
    platform; any other platform has no kernel route and raises."""
    try:
        return _KERNEL_MODE[platform]
    except KeyError:
        raise ValueError(
            f"faiss_tpu runs on platforms {sorted(_KERNEL_MODE)}, "
            f"not {platform!r}") from None


def tuning_for(platform: str, device_kind: str) -> KernelTuning:
    """The tuning row of ``device_kind`` (the CPU row for any CPU)."""
    key = "cpu" if platform == "cpu" else device_kind
    try:
        return _KIND_TUNING[key]
    except KeyError:
        raise ValueError(
            f"no tuning for device kind {device_kind!r}; known kinds: "
            f"{sorted(_KIND_TUNING)}") from None


@dataclasses.dataclass(frozen=True)
class TpuDeviceCapabilities:
    """Runtime hardware description (≈ MetalDeviceCapabilities)."""

    platform: str                 # "gpu" | "cpu"
    device_kind: str              # e.g. "NVIDIA H100 80GB HBM3"
    num_devices: int
    num_local_devices: int
    hbm_bytes: Optional[int]      # per-device, if the runtime reports it
    kernel_mode: str              # "compiled" | "interpret"
    tuning: KernelTuning

    @property
    def interpret(self) -> bool:
        """Whether Pallas kernels run in the interpreter (CPU only)."""
        return self.kernel_mode == "interpret"

    def describe(self) -> str:
        lines = [
            "faiss_tpu device capabilities:",
            f"  platform            : {self.platform}",
            f"  device_kind         : {self.device_kind}",
            f"  num_devices         : {self.num_devices}"
            f" (local {self.num_local_devices})",
            f"  hbm_bytes/device    : {self.hbm_bytes}",
            f"  kernel mode         : {self.kernel_mode}",
            f"  tuning              : {self.tuning}",
        ]
        return "\n".join(lines)


def _probe_hbm_bytes(device) -> Optional[int]:
    try:
        stats = device.memory_stats()
        if stats and "bytes_limit" in stats:
            return int(stats["bytes_limit"])
    except Exception:
        pass
    return None


def query_device_capabilities(
    devices: Optional[Sequence[jax.Device]] = None,
) -> TpuDeviceCapabilities:
    """Probe the runtime (≈ queryDeviceCapabilities, MetalDeviceCapabilities.mm:8-96)."""
    devices = list(devices) if devices is not None else list(jax.devices())
    d0 = devices[0]
    platform = d0.platform
    kind = getattr(d0, "device_kind", platform)
    return TpuDeviceCapabilities(
        platform=platform,
        device_kind=kind,
        num_devices=len(devices),
        num_local_devices=len([d for d in devices
                               if d.process_index == jax.process_index()]),
        hbm_bytes=_probe_hbm_bytes(d0),
        kernel_mode=kernel_mode_for(platform),
        tuning=tuning_for(platform, kind),
    )


def describe_capabilities(caps: Optional[TpuDeviceCapabilities] = None) -> str:
    return (caps or query_device_capabilities()).describe()


class TpuResources:
    """Resource manager: devices + 1-D mesh + compiled-fn cache.

    ≈ StandardMetalResources (src/StandardMetalResources.mm:10-45): one object
    users share across indexes. Thread-safe cache; construction is cheap (jit
    compilation happens lazily on first search, like the reference's lazy
    first-dispatch warm-up).
    """

    SHARD_AXIS = "shards"

    def __init__(self, devices: Optional[Sequence[jax.Device]] = None):
        self._devices = list(devices) if devices is not None else list(jax.devices())
        if not self._devices:
            raise RuntimeError("no JAX devices available")
        self._caps = query_device_capabilities(self._devices)
        self._cache: Dict[Any, Any] = {}
        self._pending: Dict[Any, threading.Event] = {}
        self._lock = threading.Lock()
        self._mesh: Optional[jax.sharding.Mesh] = None

    # -- devices / mesh ------------------------------------------------------
    @property
    def devices(self):
        return self._devices

    @property
    def capabilities(self) -> TpuDeviceCapabilities:
        return self._caps

    @property
    def default_device(self) -> jax.Device:
        return self._devices[0]

    def mesh(self, n: Optional[int] = None) -> jax.sharding.Mesh:
        """1-D mesh over the database (nv) axis."""
        if n is None:
            n = len(self._devices)
        if self._mesh is None or self._mesh.devices.size != n:
            self._mesh = jax.sharding.Mesh(
                np.asarray(self._devices[:n]), (self.SHARD_AXIS,)
            )
        return self._mesh

    # -- compiled-program cache ---------------------------------------------
    def cached(self, key, builder):
        """Return cache[key], building it once if absent.

        The builder runs OUTSIDE the global lock under a per-key event:
        program builds can take minutes, and holding the one lock across a
        build would wedge every concurrent search on the index behind one
        certificate-fallback compile. Concurrent callers of the SAME key
        wait on its event; other keys proceed."""
        with self._lock:
            got = self._cache.get(key)
            if got is None:
                pending = self._pending.get(key)
                if pending is None:
                    pending = self._pending[key] = threading.Event()
                    owner = True
                else:
                    owner = False
        if got is not None:
            return got
        if not owner:
            pending.wait()
            with self._lock:
                if key in self._cache:
                    return self._cache[key]
            # builder raised in the owner — re-attempt in this thread
            return self.cached(key, builder)
        try:
            fn = builder()
        except BaseException:
            with self._lock:
                self._pending.pop(key, None)
            pending.set()
            raise
        with self._lock:
            self._cache[key] = fn
            self._pending.pop(key, None)
        pending.set()
        return fn

    def cache_info(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._cache)}

    def describe(self) -> str:
        return self._caps.describe() + f"\n  fn-cache entries    : {self.cache_info()['entries']}"


_default_resources: Optional[TpuResources] = None
_default_lock = threading.Lock()


def default_resources() -> TpuResources:
    """Process-wide default (≈ MetalContext::instance(), src/MetalContext.mm:8-11)."""
    global _default_resources
    with _default_lock:
        if _default_resources is None:
            _default_resources = TpuResources()
        return _default_resources
