"""What the accelerator is, asked without opening it in this process.

Measurement entry points (bench.py, chip_smoke.py) name the card beside
every number and refuse to run on anything but a GPU. Both questions are
answered by child processes, so the caller can decide before it touches JAX
itself: a JAX process reserves most of the card's memory when it first uses
it, and the pipeline worker that such an entry point may start next needs
the card to itself.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_PROBE = (
    "import json, jax; d = jax.devices(); "
    "print(json.dumps({'platform': d[0].platform, "
    "'kind': d[0].device_kind, 'count': len(d)}))"
)


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W". Raises RuntimeError without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi lists no card")
    return lines[0]


def probe(env: dict | None = None) -> dict:
    """{"platform", "kind", "count"} of JAX's default devices, as a fresh
    process with `env` (default: this one's) sees them. The child allocates
    on demand only and exits before this returns, so the card is free again
    afterwards."""
    env = dict(os.environ if env is None else env, XLA_PYTHON_CLIENT_PREALLOCATE="false")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        capture_output=True, text=True, timeout=300, env=env,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"device probe failed: {proc.stderr.strip()[-600:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def require_gpu() -> dict:
    """probe(), raising RuntimeError unless the default platform is "gpu"."""
    dev = probe()
    if dev["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default platform is {dev['platform']!r} "
            f"({dev['kind']}); device metrics need the card"
        )
    return dev


def describe() -> dict:
    """The device fields every measurement line carries, read in-process
    (call only once this process owns the card)."""
    import jax

    d = jax.devices()
    return {
        "platform": d[0].platform,
        "device_kind": d[0].device_kind,
        "device_count": len(d),
    }
