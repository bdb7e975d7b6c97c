"""End-to-end fleet benchmark: N concurrent mode-I ensembles, RF in ->
audio access units out, one card.

The north star is concurrent real-time ensembles demodulated+decoded per
card (ROADMAP.md). This harness runs the full receive chain —
MultiStreamDemodulator (batched frame steps) -> ReceiverFleet (FIC batched
across ensembles, MSC batched across every channel of every ensemble) ->
superframe/AU host layer — and reports the aggregate ingest rate as a
multiple of the 2.048 MSPS per-ensemble SLO.

Timing is honest by construction: every dispatch's decoded bits are fetched
back to host (the byte-protocol layers consume them), so the measurement
cannot be an enqueue-rate artifact. --fused drives the served path
(FusedFleet), the way bench.py does.

Usage: python tools/bench_fleet.py --streams 16 --frames 20 [--backend cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dab_radio_tpu.utils.backend import add_backend_flag, apply_backend  # noqa: E402
from dab_radio_tpu.utils.cache import enable_compile_cache  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--services", type=int, default=2,
                    help="DAB+ services per ensemble")
    add_backend_flag(ap)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="rounds of deferred host fetch (hides device latency)")
    ap.add_argument("--viterbi", default="exact",
                    choices=["exact", "tiled", "radix8"])
    ap.add_argument("--viterbi-branch", default="matmul",
                    choices=["matmul", "lut"],
                    help="branch-metric route: (128,4) matmul or the "
                         "16-entry LUT factorization (bit-identical ACS "
                         "lever)")
    ap.add_argument("--chainback", default="sequential",
                    choices=["sequential", "parallel", "fused"],
                    help="Viterbi traceback: sequential scan, log-depth "
                         "map composition, or traceback-free register "
                         "exchange (latency levers)")
    ap.add_argument("--no-fuse-fic", action="store_true",
                    help="(fused only) decode FIC as a separate Viterbi "
                         "pass instead of riding the MSC scan (A/B lever)")
    ap.add_argument("--frames-per-step", type=int, default=1,
                    help="fuse K demod tracking steps per device dispatch")
    ap.add_argument("--fused", action="store_true",
                    help="single-dispatch rounds: demod+FIC+MSC in ONE "
                         "jitted program per K frames (multichip_receiver_"
                         "step on the local device), host does only "
                         "FIG/superframe byte work on the small decoded "
                         "outputs — the reference's benchmark mode "
                         "(--radio-enable-benchmark) force-decodes every "
                         "subchannel the same way")
    ap.add_argument("--ingest", default="u8", choices=["u8", "c64"],
                    help="u8 uploads raw bytes and dequantizes on device "
                         "(4x less host->device traffic)")
    ap.add_argument("--block-tracking", action="store_true",
                    help="(fused only) demod all K frames of a round as one "
                         "vmap batch with per-block (not per-frame) sync "
                         "updates (lifts the demod batch from N to N*K)")
    ap.add_argument("--both", action="store_true",
                    help="(fused only) measure resident (chip-bound) AND "
                         "u8-ingest (link-bound) modes in one process, "
                         "sharing the compiled program — prints two JSON "
                         "lines")
    ap.add_argument("--overlap", action="store_true",
                    help="(fused only) measure compute/H2D overlap: times "
                         "a compute-only loop, an upload-only loop, and a "
                         "loop fed by the double-buffered ingest feeder "
                         "(host.feeder), and reports overlap efficiency — "
                         "whether PCIe ingest hides behind compute (reference "
                         "ThreadedRingBuffer, app_io_buffers.h:189-245)")
    ap.add_argument("--latency", action="store_true",
                    help="per-round latency percentiles in resident mode "
                         "(no deferred fetch): the artifact for the "
                         "--viterbi tiled / --chainback parallel levers")
    ap.add_argument("--resident", action="store_true",
                    help="(fused only) pre-stage the whole IQ capture on "
                         "device before timing: measures the card-bound "
                         "fused-round throughput without host->device "
                         "ingest. Host byte-layer consume runs after the "
                         "timed loop and is reported separately.")
    ap.add_argument("--fetch-bits", action="store_true",
                    help="fetch soft bits to host between demod and decode "
                         "(legacy path; default chains on device)")
    args = ap.parse_args(argv)
    apply_backend(args)
    enable_compile_cache()

    import numpy as np
    import jax
    if args.viterbi != "exact":
        assert args.fused or args.viterbi != "radix8", \
            "radix8 is a fused-path lever (dynamic MSC path: exact/tiled)"
        if not args.fused:
            from dab_radio_tpu.dab.msc import set_decode_mode
            set_decode_mode(args.viterbi)
    from dab_radio_tpu.models.demodulator import OFDMDemodulator
    from dab_radio_tpu.models.multistream import MultiStreamDemodulator
    from dab_radio_tpu.models.fleet import ReceiverFleet

    N, F = args.streams, args.frames
    print(f"# backend={jax.default_backend()} streams={N} frames={F}",
          file=sys.stderr)

    # one synthetic ensemble's IQ, replicated across streams (identical
    # decode work per stream; receivers keep independent state). Synthesis is
    # host tooling — run it on CPU in a subprocess (it never holds the card)
    # and cache the capture (tools/_capture.py: the cache key is shared with
    # bench.py, chip_smoke.py and the other bench tools).
    from _capture import make_capture
    t0 = time.time()
    iq = make_capture(args.services, F + 3,
                      "u8" if args.ingest == "u8" else "c64")
    spc = 2 if args.ingest == "u8" else 1     # buffer units per sample
    print(f"# synth {F + 3} frames in {time.time() - t0:.1f}s", file=sys.stderr)

    if args.fused:
        return run_fused(args, iq)

    demod = OFDMDemodulator(1)
    ms = MultiStreamDemodulator(demod, N,
                                frames_per_step=args.frames_per_step,
                                ingest=args.ingest,
                                fetch_bits=args.fetch_bits)
    fleet = ReceiverFleet(N, pipeline_depth=args.pipeline_depth)
    aus = [0] * N

    def attach(k):
        def on_channel(sub_id, ch):
            ch.events.on_access_unit.append(
                lambda i, n, au, hdr: aus.__setitem__(k, aus[k] + 1))
        fleet.receivers[k].on_audio_channel.append(on_channel)
    for k in range(N):
        attach(k)

    def feed_fleet(res):
        """step() may emit several frames per stream (frames_per_step>1);
        the fleet takes one frame per receiver per round."""
        rounds = {}
        for i, bits in res:
            rounds.setdefault(i, []).append(bits)
        for k in range(max(len(v) for v in rounds.values())):
            fleet.process_frames([(i, v[k]) for i, v in rounds.items()
                                  if len(v) > k])

    # warmup: acquire all streams + first frames (compiles everything)
    p = demod.params
    warm = 3 * p.nb_frame_samples + demod.window_len
    for k in range(N):
        ms.push(k, iq[:spc * warm])
    t0 = time.time()
    for _ in range(16):
        res = ms.step()
        if res:
            feed_fleet(res)
        if all(ms.tracking) and ms.frames_emitted >= 2 * N:
            break
    print(f"# warmup {time.time() - t0:.1f}s tracking={int(ms.tracking.sum())}"
          f"/{N} frames={ms.frames_emitted}", file=sys.stderr)

    # steady state: feed the remaining frames and time the full chain
    feed = iq[spc * warm:]
    chunk = spc * p.nb_frame_samples
    nb_rounds = feed.shape[0] // chunk
    emitted0 = ms.frames_emitted
    t0 = time.time()
    for r in range(nb_rounds):
        blk = feed[r * chunk:(r + 1) * chunk]
        for k in range(N):
            ms.push(k, blk)
        res = ms.step()
        if res:
            feed_fleet(res)
    fleet.flush()
    dt = time.time() - t0
    frames_done = ms.frames_emitted - emitted0

    nb_rounds_total = feed.shape[0] // chunk
    samples = frames_done * p.nb_frame_samples
    msps = samples / dt / 1e6
    rt = msps / 2.048
    result = {
        "metric": "fleet_end_to_end_throughput",
        "streams": N,
        "frames_decoded": frames_done,
        "seconds": round(dt, 3),
        "msps_aggregate": round(msps, 2),
        "realtime_ensembles": round(rt, 2),
        "channels": fleet.summary()["channels"],
        "access_units": int(sum(aus)),
    }
    print(json.dumps(result))
    assert sum(aus) > 0, "no audio decoded — benchmark not end-to-end"
    return 0





def run_fused(args, iq):
    """One jitted program per K-frame round over all N streams, driving
    the production FusedFleet (models/fused_fleet.py) so the bench
    measures the same pack/consume byte layer serving uses."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import time as _time
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig, get_ofdm_params

    assert args.ingest == "u8", "fused path feeds raw u8"
    N = args.streams
    K = max(args.frames_per_step, 1)
    S = args.services
    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(S)]
    fleet = FusedFleet(N, cfgs, transmission_mode=1, frames_per_step=K,
                       block_tracking=args.block_tracking,
                       viterbi=args.viterbi, chainback=args.chainback,
                       viterbi_branch=args.viterbi_branch,
                       fuse_fic=not args.no_fuse_fic)

    fs = get_ofdm_params(1).nb_frame_samples
    chunk = 2 * K * fs
    rounds = iq.shape[0] // chunk

    tb = fleet.tail_bytes
    use_resident = (args.resident or args.both or args.latency
                    or args.overlap)
    if use_resident:
        # stage the whole capture on device ONCE (~0.4 MB/frame u8,
        # un-replicated: all N streams decode the same broadcast), then
        # slice + broadcast on device each round (+tail: the next round's
        # head feeds the final frame's timing margin)
        dev_iq = jax.device_put(jnp.asarray(
            np.concatenate([iq[:rounds * chunk],
                            np.full(tb, 127, np.uint8)])))
        prep = jax.jit(lambda a, r: (
            jnp.broadcast_to(
                jax.lax.dynamic_slice(a, (r,), (chunk,))[None], (N, chunk)),
            jnp.broadcast_to(
                jax.lax.dynamic_slice(a, (r + chunk,), (tb,))[None],
                (N, tb))))

    def get_blk(r, resident):
        if resident:
            return prep(dev_iq, jnp.int32(r * chunk))
        blk = jnp.asarray(np.tile(iq[r * chunk:(r + 1) * chunk][None],
                                  (N, 1)))
        t = iq[(r + 1) * chunk:(r + 1) * chunk + tb]
        tail = jnp.asarray(np.tile(t[None], (N, 1))) \
            if t.shape[0] == tb else None
        return blk, tail

    def warmup(resident):
        """Round 0: compiles on first call, then refills the
        deinterleaver after each reset (output discarded)."""
        t0 = _time.time()
        blk, tail = get_blk(0, resident)
        fleet._carry, fleet._hist, out = fleet.step(
            fleet._carry, fleet._hist, blk, tail)
        _ = [np.asarray(x) for x in fleet._pack(out)]
        return _time.time() - t0

    print(f"# fused compile {warmup(use_resident):.1f}s", file=sys.stderr)

    def run_mode(resident, max_rounds=None):
        t0 = _time.time()
        done = 0
        fetch = None
        fetched = []
        for r in range(1, min(rounds, max_rounds or rounds)):
            blk, tail = get_blk(r, resident)
            fleet._carry, fleet._hist, out = fleet.step(
                fleet._carry, fleet._hist, blk, tail)
            if fetch is not None:        # overlap host work w/ device round
                if resident:
                    fetched.append(fetch)    # defer byte work past timing
                else:
                    fleet._consume(*fetch)
            packed = fleet._pack(out)
            fetch = (np.asarray(packed[0]), np.asarray(packed[1]))
            done += N * K
        dt = _time.time() - t0           # last fetch already materialized
        # consume-phase self-diagnosis: per-round times + scheduler/fault
        # counters, so a slow consume says why: high inv_ctx_switches =>
        # host CPU contention; high major_faults => paging; one outlier
        # round => data-dependent (RS corrections).
        import resource
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t1 = _time.time()
        per_round = []
        for f in fetched:
            tr = _time.time()
            fleet._consume(*f)
            per_round.append(round(_time.time() - tr, 3))
        if fetch is not None:
            tr = _time.time()
            fleet._consume(*fetch)
            per_round.append(round(_time.time() - tr, 3))
        consume_dt = _time.time() - t1
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        consume_diag = {
            "per_round_s": per_round,
            "inv_ctx_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
            "vol_ctx_switches": ru1.ru_nvcsw - ru0.ru_nvcsw,
            "minor_faults": ru1.ru_minflt - ru0.ru_minflt,
            "major_faults": ru1.ru_majflt - ru0.ru_majflt,
            "cpu_time_s": round((ru1.ru_utime + ru1.ru_stime)
                                - (ru0.ru_utime + ru0.ru_stime), 3),
        }
        msps = done * fs / dt / 1e6
        result = {
            "metric": "fleet_end_to_end_throughput",
            "mode": "fused-resident" if resident else "fused",
            "streams": N,
            "frames_decoded": done,
            "seconds": round(dt, 3),
            "host_consume_seconds": round(consume_dt, 3),
            "consume_diag": consume_diag,
            "msps_aggregate": round(msps, 2),
            "realtime_ensembles": round(msps / 2.048, 2),
            "channels": sum(len(r_.channels) for r_ in fleet.receivers),
            "services": sum(len(r_.db.services) for r_ in fleet.receivers),
            "access_units": int(fleet.total_aus),
            "viterbi_mode": args.viterbi,
            "chainback": args.chainback,
            "viterbi_branch": args.viterbi_branch,
        }
        print(json.dumps(result), flush=True)
        assert fleet.total_aus > 0, \
            f"{result['mode']}: no access units - benchmark not end-to-end"

    def run_latency(max_rounds=None):
        """Round-trip latency: dispatch one round and FULLY materialize
        its packed outputs before starting the next (no pipelining) —
        what a lowest-latency serving deployment would see per round."""
        if rounds <= 1:
            print(f"# latency mode needs >= 2 rounds in the capture "
                  f"(have {rounds}: {iq.shape[0]} samples at {chunk}/round)"
                  " — raise --frames", file=sys.stderr)
            return 1
        times = []
        for r in range(1, min(rounds, max_rounds or rounds)):
            blk, tail = get_blk(r, True)
            t0 = _time.time()
            fleet._carry, fleet._hist, out = fleet.step(
                fleet._carry, fleet._hist, blk, tail)
            packed = fleet._pack(out)
            fetch = (np.asarray(packed[0]), np.asarray(packed[1]))
            times.append(_time.time() - t0)
            fleet._consume(*fetch)      # byte layer outside the timing
        ms = np.sort(np.asarray(times) * 1e3)
        result = {
            "metric": "fleet_round_latency",
            "streams": N, "frames_per_round": fleet.frames_per_round,
            "rounds": len(ms),
            "round_ms_min": round(float(ms[0]), 2),
            "round_ms_p50": round(float(ms[len(ms) // 2]), 2),
            "round_ms_p90": round(
                float(ms[min(int(len(ms) * 0.9), len(ms) - 1)]), 2),
            "realtime_factor_p50": round(
                fleet.frames_per_round * 96.0 / float(ms[len(ms) // 2]), 2),
            "access_units": int(fleet.total_aus),
            "viterbi_mode": args.viterbi,
            "chainback": args.chainback,
            "viterbi_branch": args.viterbi_branch,
        }
        print(json.dumps(result), flush=True)
        assert fleet.total_aus > 0, "latency mode: no access units"

    def run_overlap():
        """Three loops over the same rounds — compute-only (device-
        resident input), H2D-only (upload + dependent fetch, no compute),
        and feeder-overlapped (the double-buffered staging thread uploads
        round r+1 while round r computes). All three fetch the packed
        outputs per round like a real serving loop; the byte layer is
        excluded from all three. overlap_efficiency = how much of the
        smaller of (compute, H2D) is hidden behind the larger."""
        from dab_radio_tpu.host.feeder import DoubleBufferedFeeder
        R = rounds - 1
        if R < 2:
            print(f"# overlap mode needs >= 3 rounds in the capture "
                  f"(have {rounds}) — raise --frames", file=sys.stderr)
            return 1

        def host_round(r):
            blk = np.ascontiguousarray(
                np.tile(iq[r * chunk:(r + 1) * chunk][None], (N, 1)))
            t = iq[(r + 1) * chunk:(r + 1) * chunk + tb]
            tail = np.ascontiguousarray(np.tile(t[None], (N, 1))) \
                if t.shape[0] == tb else None
            return blk, tail

        def timed_compute(get):
            t0 = _time.time()
            for item in get:
                blk, tail = item
                fleet._carry, fleet._hist, out = fleet.step(
                    fleet._carry, fleet._hist, blk, tail)
                packed = fleet._pack(out)
                _ = (np.asarray(packed[0]), np.asarray(packed[1]))
            return _time.time() - t0

        # 1) compute-only (device-resident slices)
        fleet.reset()
        t_c = timed_compute(get_blk(r, True) for r in range(1, R + 1))

        # 2) H2D-only: upload each round and force completion with a
        #    dependent 1-element fetch
        t0 = _time.time()
        for r in range(1, R + 1):
            blk, tail = host_round(r)
            d = jax.device_put(blk)
            if tail is not None:
                dt_ = jax.device_put(tail)
                _ = np.asarray(dt_[:1, :1])
            _ = np.asarray(d[:1, :1])
        t_h2d = _time.time() - t0

        # 3) overlapped: feeder stages H2D on its own thread, depth 2
        fleet.reset()
        rs = iter(range(1, R + 1))

        def src():
            r = next(rs, None)
            return None if r is None else host_round(r)

        with DoubleBufferedFeeder(src, depth=2) as feeder:
            t_fed = timed_compute(iter(feeder))

        # 4) feeder with a DEVICE-RESIDENT source: same staging thread +
        #    bounded queue, but src() hands over device slices, so
        #    transfer cost is ~nil. This isolates the feeder machinery's
        #    own overhead: device_busy_resident is the saturation number
        #    without ingest, t_overlapped_s the one with PCIe ingest.
        fleet.reset()
        rs2 = iter(range(1, R + 1))

        def src_res():
            r = next(rs2, None)
            return None if r is None else get_blk(r, True)

        with DoubleBufferedFeeder(src_res, depth=2) as feeder2:
            t_fed_res = timed_compute(iter(feeder2))

        hidden = t_c + t_h2d - t_fed
        raw = hidden / max(min(t_c, t_h2d), 1e-9)
        eff = max(0.0, min(1.0, raw))
        result = {
            "metric": "ingest_overlap",
            "streams": N, "frames_per_round": fleet.frames_per_round,
            "rounds": R,
            "h2d_bytes_per_round": int(N * (chunk + tb)),
            "t_compute_s": round(t_c, 3),
            "t_h2d_s": round(t_h2d, 3),
            "t_overlapped_s": round(t_fed, 3),
            "overlap_efficiency": round(eff, 3),
            # unclamped: >1 means the overlapped loop beat the sum of the
            # two single-resource baselines — i.e. a baseline itself
            # overstates its resource's cost (round-4 ADVICE: the r4
            # record's clamped 1.0 hid a raw 2.21, a sign the H2D-only
            # loop was not a clean transfer-cost measurement)
            "overlap_hidden_ratio_raw": round(raw, 3),
            "device_busy_fraction": round(min(1.0, t_c / t_fed), 3),
            "t_feeder_resident_s": round(t_fed_res, 3),
            "device_busy_resident": round(min(1.0, t_c / t_fed_res), 3),
            "feeder_overhead_frac": round(max(0.0, t_fed_res / t_c - 1.0),
                                          3),
            "bound": "compute" if t_c >= t_h2d else "ingest",
            "feeder_producer_wait_s": round(
                feeder.stats.producer_wait_s, 3),
            "feeder_consumer_wait_s": round(
                feeder.stats.consumer_wait_s, 3),
        }
        print(json.dumps(result), flush=True)
        return 0

    if args.overlap:
        return run_overlap() or 0

    if args.latency:
        rc = run_latency()
        return rc or 0

    if args.both:
        run_mode(True)
        # host-ingest pass on the same compiled step: restart decode state
        # so the replayed capture stays frame-aligned (no carry-over phase
        # discontinuity) and its access_units count verifies THIS pass
        fleet.reset()
        warmup(False)
        run_mode(False, max_rounds=6)
    else:
        run_mode(use_resident)
    return 0


if __name__ == "__main__":
    sys.exit(main())
