"""Benchmark of the three accelerator paths on one GPU, in one process.

    python bench.py

Prints one JSON record per measurement; every record names the device it
ran on (platform, device kind and count, each card's name and power limit
as nvidia-smi reports them):

  demod   mode-I OFDM demod frame step (sync + CFO correction + 77x2048 FFT
          + DQPSK + deinterleave + int8 soft demap), vmapped over a batch of
          streams: Msamples/s.
  viterbi radix-4 ACS + chainback on the EEP-3A 48 CU shape: decoded
          Mbit/s.
  fleet   the served path, FusedFleet.process_round fed u8 IQ from host
          memory (defer_fetch, host byte layer included): real-time
          ensembles, round p50/p90, compile seconds.

The real-time baseline is one 2.048 MS/s ensemble. Without a GPU the run
fails; it does not fall back to the CPU.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

ENSEMBLE_MSPS = 2.048
FRAME_SECONDS = 0.096
SERVICES = 2                             # the bench capture's DAB+ services
SUBCHANNELS = "0:48:EEP3A,48:48:EEP3A"   # ... on these subchannels


def _record(metric: str, value: float, unit: str, **fields) -> dict:
    from dab_radio_tpu.utils.backend import device_record
    return {"metric": metric, "value": value, "unit": unit, **fields,
            **device_record()}


def measure_demod(batch: int = 128, iters: int = 30) -> dict:
    import jax
    from dab_radio_tpu.models.demodulator import DemodCarry, OFDMDemodulator
    demod = OFDMDemodulator(1)
    rng = np.random.default_rng(0)
    wins = jax.device_put(rng.normal(
        0, 0.5, (batch, demod.window_len, 2)).astype(np.float32))
    carry = DemodCarry.init((batch,))
    t0 = time.perf_counter()
    c, out = demod.frame_step_batch(carry, wins)
    jax.block_until_ready(out["bits"])
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        c, out = demod.frame_step_batch(c, wins)
    jax.block_until_ready((c, out["bits"]))
    dt = time.perf_counter() - t0
    msps = batch * demod.params.nb_frame_samples * iters / dt / 1e6
    return _record("demod_throughput", msps, "Msamples/s", batch=batch,
                   iters=iters, seconds=dt, compile_seconds=compile_s,
                   realtime_ensembles=msps / ENSEMBLE_MSPS)


def measure_viterbi(batch: int = 16384, iters: int = 8) -> dict:
    import jax
    from dab_radio_tpu.ops import viterbi as vit
    from dab_radio_tpu.params import SubchannelConfig, msc_puncture_schedule
    spec = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(
        SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)))
    rng = np.random.default_rng(0)
    soft = jax.device_put(rng.integers(
        -127, 128, (batch, spec.nb_in)).astype(np.int8))
    decode = jax.jit(lambda x: vit.viterbi_decode(x, spec)[0])
    t0 = time.perf_counter()
    jax.block_until_ready(decode(soft))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        bits = decode(soft)
    jax.block_until_ready(bits)
    dt = time.perf_counter() - t0
    mbps = batch * spec.nb_data_bits * iters / dt / 1e6
    return _record("viterbi_throughput", mbps, "Mbit/s", batch=batch,
                   iters=iters, trellis_steps=spec.nb_steps, seconds=dt,
                   compile_seconds=compile_s)


def serve_rounds(iq: np.ndarray, nb_streams: int, K: int, mesh=None,
                 on_access_unit=None) -> dict:
    """Serve `iq` on every stream through FusedFleet.process_round: host
    u8 blocks, defer_fetch, the next round's head as tail. Round 0 compiles
    and is not timed. Returns the timing record's fields."""
    import jax
    from dab_radio_tpu.apps.fleet_serve import parse_subchannels
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    cfgs, _ = parse_subchannels(SUBCHANNELS)
    fleet = FusedFleet(nb_streams, cfgs, transmission_mode=1,
                       frames_per_step=K, mesh=mesh)
    if on_access_unit is not None:
        fleet.on_access_unit.append(on_access_unit)
    chunk, tb = 2 * fleet.round_samples, fleet.tail_bytes
    rounds = (iq.shape[0] - tb) // chunk
    if rounds < 4:
        raise ValueError(f"capture holds {rounds} rounds; 4 needed")

    def block(a, n):
        return np.ascontiguousarray(np.broadcast_to(a, (nb_streams, n)))
    blocks = [(block(iq[r * chunk:(r + 1) * chunk], chunk),
               block(iq[(r + 1) * chunk:(r + 1) * chunk + tb], tb))
              for r in range(rounds)]
    t0 = time.perf_counter()
    fleet.process_round(blocks[0][0], defer_fetch=True,
                        tail_u8=blocks[0][1])
    compile_s = time.perf_counter() - t0
    times = []
    t_start = time.perf_counter()
    for blk, tail in blocks[1:]:
        t0 = time.perf_counter()
        fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
        times.append(time.perf_counter() - t0)
    fleet.flush()
    wall = time.perf_counter() - t_start
    ms = np.asarray(times) * 1e3
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "streams": nb_streams, "frames_per_step": K,
        "frames_per_round": fleet.frames_per_round,
        "rounds_timed": len(times), "seconds": wall,
        "compile_seconds": compile_s,
        "round_ms_p50": float(np.percentile(ms, 50)),
        "round_ms_p90": float(np.percentile(ms, 90)),
        "realtime_ensembles": nb_streams * fleet.frames_per_round
        * len(times) * FRAME_SECONDS / wall,
        "access_units": int(fleet.total_aus),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def measure_fleet(streams: int = 16, K: int = 16, rounds: int = 6) -> dict:
    from _capture import make_capture
    iq = make_capture(SERVICES, rounds * K + 1)
    res = serve_rounds(iq, streams, K)
    if res["access_units"] <= 0:
        raise RuntimeError("fleet decoded no access units")
    return _record("fleet_realtime_ensembles", res["realtime_ensembles"],
                   "ensembles", **res)


def main() -> int:
    import jax
    from dab_radio_tpu.utils.cache import enable_compile_cache
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    for measure in (measure_demod, measure_viterbi, measure_fleet):
        print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
