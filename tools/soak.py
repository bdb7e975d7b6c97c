"""Serving soak: run the fused fleet over a looped capture for N seconds and
verify the long-running contract (models/fused_fleet.py docstring): constant
memory, constant decode rate, no state drift.

Samples every --sample-s seconds: rounds, access units, RSS (VmRSS). Exit 0
requires (a) AUs still arriving in the final sample window and (b) RSS growth
after the warmup sample below --max-rss-growth (fraction). Prints one JSON
line with the samples — CI-friendly, and the same harness scales to hours.

Usage:
  python tools/soak.py --seconds 120 [--streams 4] [--frames-per-step 8]
      [--backend cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _capture import make_capture  # noqa: E402
from dab_radio_tpu.utils.backend import add_backend_flag, apply_backend  # noqa: E402
from dab_radio_tpu.utils.cache import enable_compile_cache  # noqa: E402


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seconds", type=int, default=120)
    ap.add_argument("--sample-s", type=int, default=15)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--frames-per-step", type=int, default=8)
    ap.add_argument("--capture-frames", type=int, default=40)
    ap.add_argument("--max-rss-growth", type=float, default=0.15)
    ap.add_argument("--audio", action="store_true",
                    help="also decode subchannel 0 to PCM on every stream")
    ap.add_argument("--viterbi", default="exact",
                    choices=["exact", "tiled"])
    ap.add_argument("--chainback", default="sequential",
                    choices=["sequential", "parallel"])
    add_backend_flag(ap)
    args = ap.parse_args(argv)
    apply_backend(args)
    enable_compile_cache()

    import numpy as np
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig, get_ofdm_params

    # one synthesized ensemble capture (cached; CPU subprocess)
    iq = make_capture(args.services, args.capture_frames)

    N, K = args.streams, args.frames_per_step
    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(args.services)]
    fleet = FusedFleet(N, cfgs, transmission_mode=1, frames_per_step=K,
                       viterbi=args.viterbi, chainback=args.chainback)
    if args.audio:
        for k in range(N):
            fleet.enable_audio(k, 0)
    fs = get_ofdm_params(1).nb_frame_samples
    chunk = 2 * K * fs
    tb = fleet.tail_bytes
    # whole-frame loop point keeps the stream frame-aligned across wraps
    usable = (iq.shape[0] // chunk) * chunk
    pos = 0

    def next_block():
        nonlocal pos
        if pos + chunk + tb > usable:
            pos = 0
        blk = np.broadcast_to(iq[pos:pos + chunk], (N, chunk))
        tail = np.broadcast_to(iq[pos + chunk:pos + chunk + tb], (N, tb))
        pos += chunk
        return blk, tail

    t_end = time.time() + args.seconds
    samples = []
    last = {"t": time.time(), "aus": 0, "rounds": 0}
    next_sample = time.time() + args.sample_s
    while time.time() < t_end:
        blk, tail = next_block()
        fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
        if time.time() >= next_sample:
            now = time.time()
            aus, rounds = int(fleet.total_aus), int(fleet.total_rounds)
            samples.append({
                "t_s": round(now - (t_end - args.seconds), 1),
                "rounds": rounds, "aus": aus,
                "au_rate": round((aus - last["aus"]) / (now - last["t"]), 1),
                "rss_mb": round(_rss_mb(), 1)})
            last = {"t": now, "aus": aus, "rounds": rounds}
            next_sample = now + args.sample_s
            print(f"# {samples[-1]}", file=sys.stderr, flush=True)
    fleet.flush()

    # RSS baseline: the first sample taken AFTER decode actually started
    # (a slow first compile under load can leave sample 0 pre-warmup,
    # which would overstate growth)
    warm = [x for x in samples if x["rounds"] >= 2] or samples
    ok = len(samples) >= 2 and len(warm) >= 2
    growth = None
    if ok:
        ok &= samples[-1]["au_rate"] > 0
        base = warm[0]["rss_mb"]
        growth = (samples[-1]["rss_mb"] - base) / max(base, 1.0)
        ok &= growth <= args.max_rss_growth
    result = {
        "metric": "serving_soak",
        "seconds": args.seconds, "streams": N, "frames_per_step": K,
        "viterbi": args.viterbi, "chainback": args.chainback,
        "total_rounds": int(fleet.total_rounds),
        "total_aus": int(fleet.total_aus),
        "rss_growth": round(growth, 4) if growth is not None else None,
        "samples": samples,
        "ok": bool(ok),
    }
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
