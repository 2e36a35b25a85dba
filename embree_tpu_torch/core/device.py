"""Device object: config, error model, observability.

Counterpart of embree_tpu/core/device.py. One Device wraps one
`torch.device` plus the parsed State. The reference's per-thread sticky
RTCError + error-callback model (state.h:148-176, rtcore.cpp:36-53) maps
to python exceptions from a RaytracerError hierarchy plus an optional
error callback invoked before raising.

`Device()` means the CUDA device and raises when there is none; a caller
that wants the CPU says `Device(device="cpu")` or puts `device=cpu` into
the config string (the argument wins over the string). Nothing here
carries on quietly on another device than the one asked for.
"""
from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from .config import State


class Error(enum.IntEnum):
    """Mirrors RTCError (include/embree3/rtcore_common.h)."""

    NONE = 0
    UNKNOWN = 1
    INVALID_ARGUMENT = 2
    INVALID_OPERATION = 3
    OUT_OF_MEMORY = 4
    UNSUPPORTED_CPU = 5  # kept for API parity; unused
    CANCELLED = 6


class RaytracerError(RuntimeError):
    def __init__(self, code: Error, msg: str):
        super().__init__(f"{code.name}: {msg}")
        self.code = code


class Device:
    """rtcNewDevice analog (device.cpp:52): parse config, bind a device."""

    def __init__(self, cfg: Optional[str] = None, *, device=None):
        self.state = State()
        # config-file layer first so the explicit string wins (device.cpp:60-68)
        self.state.parse_string(cfg)  # pick up ignore_config_files early
        self.state.parse_config_files()
        self.state.parse_string(cfg)
        self.error_code = Error.NONE
        self.error_fn: Optional[Callable[[Error, str], None]] = None
        self.memory_monitor_fn: Optional[Callable[[int, bool], bool]] = None
        self._memory_bytes = 0
        if device is None:
            device = ("cuda" if self.state.device == "default"
                      else self.state.device)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RaytracerError(
                    Error.INVALID_OPERATION,
                    "no CUDA device is available; pass device=\"cpu\" to "
                    "run on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        if self.state.verbose >= 1:
            self.print_banner()

    # -- error model (RTC_CATCH_END analog, rtcore.cpp:36-53) ---------------
    def set_error_function(self, fn: Callable[[Error, str], None]) -> None:
        self.error_fn = fn

    def raise_error(self, code: Error, msg: str) -> None:
        self.error_code = code
        if self.error_fn is not None:
            self.error_fn(code, msg)
        raise RaytracerError(code, msg)

    def get_error(self) -> Error:
        """rtcGetDeviceError: returns and clears the sticky error."""
        code, self.error_code = self.error_code, Error.NONE
        return code

    # -- memory monitor (rtcore_device.h:90-93) ----------------------------
    def set_memory_monitor_function(self, fn: Callable[[int, bool], bool]) -> None:
        self.memory_monitor_fn = fn

    def memory_monitor(self, bytes_delta: int, post: bool) -> None:
        self._memory_bytes += bytes_delta
        if self.memory_monitor_fn is not None:
            if not self.memory_monitor_fn(bytes_delta, post):
                self.raise_error(Error.OUT_OF_MEMORY, "memory monitor veto")

    @property
    def bytes_used(self) -> int:
        return self._memory_bytes

    # -- observability (device.cpp:94-98 banner) ---------------------------
    def print_banner(self) -> None:
        if self.device.type == "cuda":
            kind = torch.cuda.get_device_name(self.device)
            count = torch.cuda.device_count()
        else:
            kind, count = "cpu", 1
        print(f"embree_tpu_torch Device: device={self.device} "
              f"devices={count} [{kind}]")
        print(f"  config: isa={self.state.isa} threads={self.state.threads} "
              f"builder={self.state.builder}")
