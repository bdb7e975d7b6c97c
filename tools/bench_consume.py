"""Host byte-layer consume benchmark (CPU-only).

Times the host half of a serving round at the 16-stream x K=16 shape
(16 streams x 16 frames x 9 rounds = 2,304 stream-frames).

This measures EXACTLY the serving fleet's host half: the packed
(fib_bytes, msc_bytes) rounds are captured once from a real fused-program
run over a synthetic 2-service ensemble, then replayed through
  a) the sequential per-stream path  (_stream_job loop — the r03 code)
  b) the batched-RS path             (_consume_batched — the default now)
with identical byte-layer state resets in between, asserting the two
paths produce identical event streams before trusting the timing.

Run:  JAX_PLATFORMS=cpu python tools/bench_consume.py [--streams 16]
      [--frames-per-step 16] [--rounds 9] [--services 2]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _capture import make_capture  # noqa: E402


def main(argv=None):
    # the byte layer is host work: the capture rounds are decoded on the
    # CPU backend so this bench never holds an accelerator
    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--frames-per-step", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    N, K, S = args.streams, args.frames_per_step, args.services
    n_frames = K * (args.rounds + 1) + 3
    iq = make_capture(S, n_frames)

    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(S)]
    fleet = FusedFleet(N, cfgs, transmission_mode=1, frames_per_step=K)
    chunk = 2 * fleet.round_samples
    tb = fleet.tail_bytes

    # capture the packed per-round host arrays once
    import jax.numpy as jnp
    fetches = []
    for r in range(min(args.rounds, iq.shape[0] // chunk - 1)):
        blk = np.tile(iq[r * chunk:(r + 1) * chunk][None], (N, 1))
        t = iq[(r + 1) * chunk:(r + 1) * chunk + tb]
        tail = jnp.asarray(np.tile(t[None], (N, 1))) if t.shape[0] == tb \
            else None
        fleet._carry, fleet._hist, out = fleet.step(
            fleet._carry, fleet._hist, jnp.asarray(blk), tail)
        fib, msc, _ = fleet._pack(out)
        fetches.append((np.asarray(fib), np.asarray(msc)))
    stream_frames = N * K * len(fetches)

    from dab_radio_tpu.ops.crc import crc16_check_batch

    def replay(batched: bool):
        """Fresh byte-layer state, replay all rounds, return
        (seconds, events, total_aus)."""
        fleet.receivers = [type(fleet.receivers[0])(fleet._mode)
                           for _ in range(N)]
        fleet._sfp = fleet._make_procs()
        fleet.total_aus = 0
        events_log = []
        orig_fire = fleet._fire

        def fire(b, events):
            events_log.append((b, [(e[0], e[1]) for e in events]))
            orig_fire(b, events)
        fleet._fire = fire
        t0 = time.time()
        try:
            for fib_bytes, msc_bytes in fetches:
                if batched:
                    fleet._consume(fib_bytes, msc_bytes)
                else:
                    B, F, G, nbytes = fib_bytes.shape
                    fibs = fib_bytes.reshape(B, F, -1, 32)
                    ok = crc16_check_batch(fibs.reshape(-1, 32)) \
                        .reshape(B, F, fibs.shape[2])
                    for b in range(N):
                        fleet._fire(b, fleet._stream_job(
                            b, fibs, ok, msc_bytes))
        finally:
            fleet._fire = orig_fire
        return time.time() - t0, events_log, fleet.total_aus

    results = {}
    for name, batched in (("sequential", False), ("batched", True)):
        best, events, aus = None, None, None
        for rep in range(args.reps):
            dt, ev, n_aus = replay(batched)
            print(f"#   {name} rep {rep}: {dt:.3f}s", file=sys.stderr)
            if best is None or dt < best:
                best, events, aus = dt, ev, n_aus
        results[name] = {"seconds": best, "aus": aus, "events": events}
        print(f"# {name}: {best:.3f}s for {stream_frames} stream-frames "
              f"({aus} AUs)", file=sys.stderr)

    assert results["sequential"]["aus"] == results["batched"]["aus"], \
        "event divergence between paths"
    assert results["sequential"]["events"] == results["batched"]["events"], \
        "event ORDER divergence between paths"
    seq, bat = (results[k]["seconds"] for k in ("sequential", "batched"))
    print(json.dumps({
        "metric": "host_consume_seconds",
        "stream_frames": stream_frames,
        "streams": N, "frames_per_step": K, "rounds": len(fetches),
        "sequential_s": round(seq, 3), "batched_s": round(bat, 3),
        "speedup": round(seq / bat, 2),
        "per_2304_stream_frames_s": round(bat * 2304 / stream_frames, 3),
        "aus": results["batched"]["aus"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
