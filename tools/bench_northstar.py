"""Many-ensemble program shape: compile and run ONE sharded serving
program at a 100-ensemble topology and check AU parity against the
single-device host path.

docs/DEPLOY.md's preferred deployment is fleet-PER-CARD (independent
16-stream programs: no cross-card traffic, no shared failure domain), but
the single-program alternative — one fused program sharded {ens: 8}
carrying all ~104 streams — must be shown to compile and decode, not
assumed.
This driver runs it on the 8-virtual-device CPU mesh
(xla_force_host_platform_device_count): 104 streams = 13 per shard,
every stream fed the same synthesized mode-I DAB+ ensemble, then asserts
every stream's decoded access-unit byte stream equals a 1-stream
unsharded FusedFleet's on the same capture (the host-path oracle used
throughout tests/test_parallel.py).

Reference bar: the C++ reference's src/ofdm/dab_ofdm_params_ref.cpp:8-9
(it serves ONE ensemble real-time on a desktop CPU). Records: compile seconds, steady round seconds, peak
RSS, AU parity. Usage:

    python tools/bench_northstar.py                  # 104 streams, {ens:8}
    python tools/bench_northstar.py --streams 16 --rounds 3   # smoke
"""

import argparse
import json
import os
import resource
import sys
import time

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=104,
                    help="total streams in ONE sharded program "
                         "(must divide by --ens-shards)")
    ap.add_argument("--ens-shards", type=int, default=8)
    ap.add_argument("--frames-per-step", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6,
                    help="serving rounds (first is compile+run)")
    ap.add_argument("--mode", type=int, default=1)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.parallel.mesh import make_receiver_mesh

    assert args.streams % args.ens_shards == 0, (args.streams,
                                                 args.ens_shards)
    mesh = make_receiver_mesh(args.ens_shards,
                              axis_sizes=(args.ens_shards, 1, 1))
    N, K = args.streams, args.frames_per_step

    # the capture: one mode-I DAB+ ensemble, 2 tone-audio services
    cfgs = [SubchannelConfig(s * 12, 12, False, eep_type="A",
                             eep_prot_level=2) for s in range(2)]
    tx = EnsembleTransmitter(
        args.mode, ensemble_id=0xC0FE, ensemble_label="NorthStar",
        services=[ServiceSpec(0xF100 + s, s, f"NS {s}", cfgs[s])
                  for s in range(len(cfgs))])
    tx.enable_tone_audio(base_freq=440.0)
    frames = []
    for _ in range(args.rounds * K):
        bits = np.asarray(tx.next_frame_bits())
        frames.append(tx.modulate_frame_bits(bits))
    iq = np.concatenate(frames)
    iq = iq / np.abs(iq).max() * 0.5
    u8 = np.clip(np.round(
        np.stack([iq.real, iq.imag], -1).reshape(-1) * 127.5 + 127.5),
        0, 255).astype(np.uint8)

    def run(fleet, n):
        aus = [dict() for _ in range(n)]
        fleet.on_access_unit.append(
            lambda b, s, i, nau, au, h:
                aus[b].setdefault(s, []).append(bytes(au)))
        chunk = 2 * fleet.round_samples
        times = []
        for r in range(args.rounds):
            blk = np.tile(u8[r * chunk:(r + 1) * chunk][None], (n, 1))
            tail = u8[(r + 1) * chunk:
                      (r + 1) * chunk + fleet.tail_bytes]
            tail = (np.tile(tail[None], (n, 1))
                    if tail.size == fleet.tail_bytes else None)
            t0 = time.time()
            fleet.process_round(blk, tail_u8=tail)
            times.append(time.time() - t0)
        return aus, times

    # ---- host-path oracle: 1 stream, no mesh ----
    ref_fleet = FusedFleet(1, cfgs, transmission_mode=args.mode,
                           frames_per_step=K)
    ref_aus, _ = run(ref_fleet, 1)
    ref = {s: b"".join(v) for s, v in ref_aus[0].items()}
    assert ref and all(len(v) > 0 for v in ref.values()), \
        "oracle produced no access units — capture too short?"

    # ---- the north-star-shape program ----
    t0 = time.time()
    fleet = FusedFleet(N, cfgs, transmission_mode=args.mode,
                       frames_per_step=K, mesh=mesh)
    t_build = time.time() - t0
    aus, times = run(fleet, N)

    mismatches = 0
    for b in range(N):
        got = {s: b"".join(v) for s, v in aus[b].items()}
        if got != ref:
            mismatches += 1
    summ = fleet.summary()
    rec = {
        "metric": "northstar_shape",
        "streams": N,
        "mesh": dict(mesh.shape),
        "streams_per_shard": N // args.ens_shards,
        "frames_per_step": K,
        "rounds": args.rounds,
        "mode": args.mode,
        "build_seconds": round(t_build, 1),
        "compile_round_seconds": round(times[0], 1),
        "steady_round_seconds": round(float(np.median(times[1:])), 2),
        "peak_rss_gb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
        "access_units": summ["access_units"],
        "au_parity_streams": N - mismatches,
        "au_mismatch_streams": mismatches,
        "ok": mismatches == 0 and summ["access_units"] > 0,
    }
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
