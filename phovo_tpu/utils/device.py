"""Which device a measurement ran on.

Every time or rate this repository prints names the device it was taken on:
JAX's view of the devices (platform, device kind, count) and the card's name
and power limit as nvidia-smi reports them — a card set below its maximum
power limit runs slower under load, so the limit belongs beside the number.
"""

from __future__ import annotations

import shutil
import subprocess


def jax_devices() -> dict:
    """{"platform", "kind", "count"} of the devices JAX uses."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_name_and_power_limit() -> list[str]:
    """One line per card, `name, power limit` exactly as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them; empty when nvidia-smi is absent or fails. Runs in a child process
    that does not use JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        p = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if p.returncode != 0:
        return []
    return [ln.strip() for ln in p.stdout.splitlines() if ln.strip()]


def require_gpu() -> dict:
    """jax_devices(), or SystemExit (non-zero) when JAX found no GPU: a
    measurement taken on another device must not pass for one."""
    dev = jax_devices()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"error: JAX found no GPU (platform {dev['platform']!r}); "
            "this measures the card and does not fall back to the CPU"
        )
    return dev


def print_device(dev: dict | None = None) -> dict:
    """Print the JAX devices and the nvidia-smi name/power-limit line(s);
    returns the JAX device dict."""
    dev = dev or jax_devices()
    print(
        f"device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}",
        flush=True,
    )
    for line in gpu_name_and_power_limit():
        print(line, flush=True)
    return dev
