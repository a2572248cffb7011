"""The accelerator a measurement runs on: a GPU-or-fail device gate, the
card's name and power limit, and published peak rates by ``device_kind``.

Every speed number this repository reports comes from a GPU run, so the
benchmark and the measurement scripts start with ``require_gpu()``: it
raises when JAX's default platform is anything else, rather than falling
back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, List

# Dense (no sparsity) peaks from NVIDIA's H100 data sheet, at the card's
# full power limit, for the cards this repository has run on; keyed by
# jax.Device.device_kind. bench.py divides by bf16_flops (MFU),
# scripts/mfu-sweep.py by hbm_bytes_per_s.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {  # H100 SXM5
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}
PEAKS_SOURCE = "NVIDIA H100 Tensor Core GPU data sheet (dense rates)"


class NoGPUError(RuntimeError):
    """JAX found no GPU to measure on."""


def require_gpu() -> List:
    """The JAX devices, if the default platform is a GPU; else raise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's default platform is "
            f"{devices[0].platform!r} ({len(devices)} device(s)); this "
            "measurement runs only on a GPU and never falls back to the CPU"
        )
    return devices


def peaks(device_kind: str) -> Dict[str, float]:
    """Published peaks of ``device_kind``; an unknown kind is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


def card_info() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise NoGPUError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    )
    return out.stdout.strip()


def device_summary() -> Dict[str, object]:
    """platform, device_kind and device count as JAX reports them."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}
