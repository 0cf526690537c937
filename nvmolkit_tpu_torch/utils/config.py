"""Hardware/batching configuration.

The port's copy of ``nvmolkit_tpu/utils/config.py::HardwareOptions``
(itself the analog of nvMolKit's ``HardwareOptions``): the same fields,
defaults, validation, JSON round-trip and ``gpuIds``/``batchesPerGpu``
aliases, with no framework import. ``deviceIds`` name CUDA devices.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class HardwareOptions:
    """Batching/scheduling knobs threaded through batch APIs.

    ``-1`` means "auto":
      * ``preprocessingThreads`` — host threads for featurization.
      * ``batchSize`` — systems per device dispatch.
      * ``batchesPerDevice`` — in-flight batches per device (nvMolKit's
        ``batchesPerGpu``).
      * ``deviceIds`` — which CUDA devices to use; empty = the default
        device (nvMolKit's ``gpuIds``). The port runs on one device.
      * ``atomBuckets`` — size classes molecules are grouped into for the
        Morgan kernel.
    """

    preprocessingThreads: int = -1
    batchSize: int = -1
    batchesPerDevice: int = -1
    deviceIds: list[int] = dataclasses.field(default_factory=list)
    atomBuckets: tuple[int, ...] = (16, 24, 32, 48, 64, 96, 128, 192, 256)
    # nvMolKit spellings accepted as constructor aliases; canonical
    # fields win when both are given
    batchesPerGpu: dataclasses.InitVar[int | None] = None
    gpuIds: dataclasses.InitVar["list[int] | None"] = None

    _FIELDS = (
        "preprocessingThreads",
        "batchSize",
        "batchesPerDevice",
        "deviceIds",
        "atomBuckets",
    )

    def __post_init__(
        self, batchesPerGpu: int | None = None, gpuIds: "list[int] | None" = None
    ) -> None:
        if batchesPerGpu is not None and self.batchesPerDevice == -1:
            self.batchesPerDevice = batchesPerGpu
        if gpuIds is not None and not self.deviceIds:
            self.deviceIds = list(gpuIds)
        for name in ("preprocessingThreads", "batchSize", "batchesPerDevice"):
            v = getattr(self, name)
            if not isinstance(v, int) or (v < 1 and v != -1):
                raise ValueError(f"{name} must be a positive int or -1 (auto), got {v!r}")
        if not all(isinstance(d, int) and d >= 0 for d in self.deviceIds):
            raise ValueError(f"deviceIds must be non-negative ints, got {self.deviceIds!r}")
        buckets = tuple(int(b) for b in self.atomBuckets)
        if not buckets or any(b < 1 for b in buckets) or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"atomBuckets must be strictly increasing positive ints, got {self.atomBuckets!r}")
        self.atomBuckets = buckets

    def to_dict(self) -> dict[str, Any]:
        return {
            "preprocessingThreads": self.preprocessingThreads,
            "batchSize": self.batchSize,
            "batchesPerDevice": self.batchesPerDevice,
            "deviceIds": list(self.deviceIds),
            "atomBuckets": list(self.atomBuckets),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "HardwareOptions":
        aliases = {"batchesPerGpu", "gpuIds"}
        unknown = set(d) - set(cls._FIELDS) - aliases
        if unknown:
            raise ValueError(f"Unknown HardwareOptions keys: {sorted(unknown)}")
        kwargs = dict(d)
        if "atomBuckets" in kwargs:
            kwargs["atomBuckets"] = tuple(kwargs["atomBuckets"])
        return cls(**kwargs)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "HardwareOptions":
        return cls.from_dict(json.loads(s))


# nvMolKit-spelling read accessors (assigned after the class so the
# dataclass InitVar machinery keeps the constructor aliases above)
HardwareOptions.batchesPerGpu = property(lambda self: self.batchesPerDevice)
HardwareOptions.gpuIds = property(lambda self: list(self.deviceIds))
