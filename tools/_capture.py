"""Shared synthetic-capture cache for the bench scripts and chip_smoke.py.

One canonical implementation of "synthesize a decodable ensemble via
simulate_transmitter on the CPU backend and cache it in the temp dir" — the
cache filename IS the contract (bench.py, chip_smoke.py, bench_fleet,
bench_stages, bench_consume and soak all read/write the same namespace, so
the transmitter flags and the key must change together). The file is
written to a temporary name in the same directory and renamed into place,
so a concurrent reader never sees a partial capture."""

import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# part of the cache key: bump it whenever the transmitter's output changes
# (labels, payload, framing), so no run reads a capture cached before
CAPTURE_VERSION = 2


def capture_path(services: int, frames: int, fmt: str = "u8") -> str:
    """Path of the cached capture of `frames` mode-I frames of a
    `services`-service tone-audio ensemble, synthesized on first use."""
    cache = os.path.join(
        tempfile.gettempdir(),
        f"dab_capture_v{CAPTURE_VERSION}_s{services}_f{frames}.{fmt}")
    if not os.path.exists(cache):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "-m",
             "dab_radio_tpu.apps.simulate_transmitter", "--backend", "cpu",
             "--payload", "ensemble", "--services", str(services),
             "-n", str(frames), "-F", "u8" if fmt == "u8" else "f32"],
            capture_output=True, cwd=ROOT, env=env)
        if r.returncode != 0:
            raise RuntimeError("simulate_transmitter failed: "
                               + r.stderr.decode()[-500:])
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache),
                                   prefix=os.path.basename(cache) + ".")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(r.stdout)
            os.replace(tmp, cache)
        except BaseException:
            os.unlink(tmp)
            raise
    return cache


def make_capture(services: int, frames: int, fmt: str = "u8") -> np.ndarray:
    """The capture_path() capture as an array: u8 bytes or complex64."""
    return np.fromfile(capture_path(services, frames, fmt),
                       dtype=np.uint8 if fmt == "u8" else np.complex64)
