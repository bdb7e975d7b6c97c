"""JAX backend selection for the CLI apps.

Every app takes a --backend flag that applies
jax.config.update("jax_platforms", ...) before the first backend
initialization: `cpu` runs the program on the host (tests, transmitter
synthesis), `gpu` requires a CUDA card, and `default` keeps whatever JAX
finds (reference analog: the apps' thread-count/arch flags,
examples/basic_radio_app.cpp:82-106 — pick the execution substrate at the
CLI).
"""

import argparse
import subprocess

BACKENDS = ("default", "cpu", "gpu")


def add_backend_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--backend", default="default", choices=BACKENDS,
        help="JAX platform override (default: whatever the environment "
             "registered)")


def apply_backend(args: argparse.Namespace) -> None:
    """Must be called before any jax computation in the app."""
    backend = getattr(args, "backend", "default")
    if backend == "default":
        return
    import jax
    jax.config.update("jax_platforms", backend)


def card_info() -> list:
    """nvidia-smi's `name, power.limit` line for every visible card; empty
    where nvidia-smi is absent or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if r.returncode != 0:
        return []
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def device_record() -> dict:
    """What a measurement ran on: JAX's platform, device kind and count,
    and each card's name and power limit."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "cards": card_info()}
