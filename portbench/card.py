"""The card's state: its name and power limit, and its SM and memory clocks,
performance state, power draw, temperature and clock-limit reasons sampled
through the measured window.

The samples come from NVML (``libnvidia-ml.so.1``, through ctypes) in a
thread that wakes every ``every_s`` seconds, so the clock that a window ran
at is read while it runs, not after it. Where NVML cannot be loaded the
state is read once after the window with ``nvidia-smi``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import threading

NVML_CLOCK_SM = 1
NVML_CLOCK_MEM = 2
NVML_TEMPERATURE_GPU = 0


class _Nvml:
    def __init__(self, index: int):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        if self.lib.nvmlInit_v2() != 0:
            raise OSError("nvmlInit_v2 failed")
        self.handle = ctypes.c_void_p()
        if self.lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index),
                                                  ctypes.byref(self.handle)) != 0:
            raise OSError(f"no NVML device {index}")

    def _uint(self, fn: str, *args) -> int | None:
        v = ctypes.c_uint()
        return v.value if getattr(self.lib, fn)(self.handle, *args, ctypes.byref(v)) == 0 else None

    def limits(self) -> dict:
        buf = ctypes.create_string_buffer(96)
        self.lib.nvmlDeviceGetName(self.handle, buf, ctypes.c_uint(96))
        limit = self._uint("nvmlDeviceGetPowerManagementLimit")
        return {"smi_name": buf.value.decode(),
                "power_limit_w": None if limit is None else limit / 1000.0}

    def sample(self) -> dict:
        reasons = ctypes.c_ulonglong()
        ok = self.lib.nvmlDeviceGetCurrentClocksThrottleReasons(self.handle,
                                                                ctypes.byref(reasons)) == 0
        power = self._uint("nvmlDeviceGetPowerUsage")
        return {"sm_clock_mhz": self._uint("nvmlDeviceGetClockInfo", ctypes.c_int(NVML_CLOCK_SM)),
                "mem_clock_mhz": self._uint("nvmlDeviceGetClockInfo",
                                            ctypes.c_int(NVML_CLOCK_MEM)),
                "pstate": self._uint("nvmlDeviceGetPerformanceState"),
                "power_w": None if power is None else power / 1000.0,
                "temp_c": self._uint("nvmlDeviceGetTemperature",
                                     ctypes.c_int(NVML_TEMPERATURE_GPU)),
                "clock_reasons": reasons.value if ok else None}


class Sampler:
    """``start()`` at the window's start, ``stop()`` at its end, then
    ``state()``: the name, the power limit and, over the window's samples,
    the SM and memory clocks' least, median and most, the performance
    states seen, the power draw's median and most, the hottest temperature
    and the union of NVML's clock-limit reasons."""

    def __init__(self, index: int = 0, every_s: float = 0.5):
        self.index, self.every_s = index, every_s
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._thread = None
        try:
            self.nvml = _Nvml(index)
        except (OSError, AttributeError):
            self.nvml = None

    def _loop(self) -> None:
        while True:
            self.samples.append(self.nvml.sample())
            if self._stop.wait(self.every_s):
                break

    def start(self) -> None:
        if self.nvml is not None:
            self._thread = threading.Thread(target=self._loop, name="card-sampler", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self.samples.append(self.nvml.sample())

    def state(self) -> dict:
        if self.nvml is None:
            return smi_state(self.index)
        out = self.nvml.limits()

        def got(k):
            return [s[k] for s in self.samples if s[k] is not None]

        for k in ("sm_clock_mhz", "mem_clock_mhz"):
            if got(k):
                out[k] = {"min": min(got(k)), "median": statistics.median(got(k)),
                          "max": max(got(k)), "samples": len(got(k))}
        out["pstates"] = sorted(set(got("pstate")))
        power = got("power_w")
        if power:
            out["power_w"] = {"median": statistics.median(power), "max": max(power)}
        if got("temp_c"):
            out["temp_c_max"] = max(got("temp_c"))
        reasons = 0
        for r in got("clock_reasons"):
            reasons |= r
        out["clock_reasons"] = hex(reasons)
        return out


def smi_state(index: int = 0) -> dict:
    """The name, power limit and SM clock now, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader,nounits", f"--id={index}"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        name, limit, clock = (s.strip() for s in out.splitlines()[0].split(","))
        return {"smi_name": name, "power_limit_w": float(limit),
                "sm_clock_mhz_after": float(clock)}
    except (OSError, ValueError, IndexError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unread: {e}"}
