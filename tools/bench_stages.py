"""Per-stage timing ablation of the fused serving round.

It compiles the SAME fused program truncated after each pipeline prefix
(parallel/mesh.py multichip_receiver_step stop_after) and times rounds on
device-resident IQ with a per-round scalar digest fetch. Successive p50
deltas are the per-stage ms table.

Stages (cumulative prefixes):
  ingest  -> demod -> subs -> deint -> depunct -> acs -> full
The 'acs' rung isolates the radix-4 forward trellis from the chainback
(full - acs ~= chainback + descramble + on-device bit-pack).

Each stage prints its own JSON line as it lands, then a summary line with
the deltas.

Usage:
  python tools/bench_stages.py --streams 16 --frames-per-step 16 \
      --rounds 5 [--stages demod,acs,full] [--backend cpu]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from _capture import make_capture as synth_capture  # noqa: E402
from dab_radio_tpu.utils.backend import add_backend_flag, apply_backend  # noqa: E402
from dab_radio_tpu.utils.cache import enable_compile_cache  # noqa: E402

ALL_STAGES = ["rtt", "ingest", "demod", "subs", "deint", "depunct", "acs",
              "full"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--frames-per-step", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed rounds per stage (after the compile round)")
    ap.add_argument("--services", type=int, default=2)
    ap.add_argument("--stages", default=",".join(ALL_STAGES),
                    help="comma list; order is preserved in the summary")
    add_backend_flag(ap)
    ap.add_argument("--viterbi", default="exact", choices=["exact", "tiled"])
    ap.add_argument("--viterbi-branch", default="matmul",
                    choices=["matmul", "lut"])
    ap.add_argument("--chainback", default="sequential",
                    choices=["sequential", "parallel", "fused"])
    ap.add_argument("--block-tracking", action="store_true")
    args = ap.parse_args(argv)
    apply_backend(args)
    enable_compile_cache()

    import numpy as np
    import jax
    import jax.numpy as jnp
    from dab_radio_tpu.parallel.mesh import (make_receiver_mesh,
                                             multichip_receiver_step)
    from dab_radio_tpu.params import SubchannelConfig, get_ofdm_params

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    assert all(s in ALL_STAGES for s in stages), stages
    N, K, S = args.streams, args.frames_per_step, args.services
    fs = get_ofdm_params(1).nb_frame_samples
    chunk = 2 * K * fs
    # enough capture for rounds+2 (warmup round 0 + tail margin)
    need_frames = K * (args.rounds + 2) + 3
    iq = synth_capture(S, need_frames)
    rounds_avail = iq.shape[0] // chunk
    R = min(args.rounds, rounds_avail - 1)
    assert R >= 2, (rounds_avail, args.rounds)
    print(f"# backend={jax.default_backend()} streams={N} K={K} "
          f"rounds={R} stages={stages}", file=sys.stderr, flush=True)

    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(S)]
    mesh = make_receiver_mesh(1, axis_sizes=(1, 1, 1))

    results = {}
    for stage in stages:
        if stage == "rtt":
            # the dispatch floor: the same loop structure (two jitted
            # dispatches + one scalar fetch) with ~zero compute. Every
            # other rung pays this fixed per-round cost too, so
            # (stage - rtt) is on-device time; and if rtt itself is a
            # large share of the full round, the serving ceiling is the
            # dispatch round trip, not the card.
            tiny = jax.device_put(jnp.float32(1.0))
            f1 = jax.jit(lambda x: x * 1.0000001)
            f2 = jax.jit(lambda x: x + 0.0)
            t0 = time.time()
            _ = float(np.asarray(f2(f1(tiny))))
            compile_s = time.time() - t0
            times = []
            for _r in range(R):
                t0 = time.time()
                _ = float(np.asarray(f2(f1(tiny))))
                times.append(time.time() - t0)
            ms = np.sort(np.asarray(times) * 1e3)
            rec = {
                "metric": "fused_stage_ablation",
                "stage": "rtt", "streams": N, "frames_per_round": K,
                "rounds": len(ms),
                "round_ms_min": round(float(ms[0]), 2),
                "round_ms_p50": round(float(ms[len(ms) // 2]), 2),
                "compile_s": round(compile_s, 1),
            }
            results[stage] = rec
            print(json.dumps(rec), flush=True)
            continue
        t_build = time.time()
        step, (carry, hist, _) = multichip_receiver_step(
            mesh, 1, frames_per_shard=K, subchannels_per_shard=S,
            ensembles_per_shard=N, ingest="u8", subchannel_cfgs=cfgs,
            block_tracking=args.block_tracking, viterbi=args.viterbi,
            chainback=args.chainback, viterbi_branch=args.viterbi_branch,
            fuse_fic=True,
            stop_after=None if stage == "full" else stage)
        tb = 2 * step.tail_samples
        dev_iq = jax.device_put(jnp.asarray(np.concatenate(
            [iq[:rounds_avail * chunk], np.full(tb, 127, np.uint8)])))
        prep = jax.jit(lambda a, r: (
            jnp.broadcast_to(
                jax.lax.dynamic_slice(a, (r,), (chunk,))[None], (N, chunk)),
            jnp.broadcast_to(
                jax.lax.dynamic_slice(a, (r + chunk,), (tb,))[None],
                (N, tb))))

        if stage == "full":
            # reduce the full round's outputs to one scalar on device so
            # every rung's timed loop fetches identically (one f32)
            @jax.jit
            def digest_out(out):
                return sum(jnp.sum(x.astype(jnp.float32))
                           for x in jax.tree_util.tree_leaves(out))
        else:
            digest_out = jax.jit(lambda out: out["digest"])

        def one_round(carry, hist, r):
            blk, tail = prep(dev_iq, jnp.int32(r * chunk))
            carry, hist, out = step(carry, hist, blk, tail)
            return carry, hist, float(np.asarray(digest_out(out)))

        # round 0: compile + state warm
        t0 = time.time()
        carry, hist, dg = one_round(carry, hist, 0)
        compile_s = time.time() - t0
        times = []
        for r in range(1, R + 1):
            t0 = time.time()
            carry, hist, dg = one_round(carry, hist, r)
            times.append(time.time() - t0)
        ms = np.sort(np.asarray(times) * 1e3)
        rec = {
            "metric": "fused_stage_ablation",
            "stage": stage, "streams": N, "frames_per_round": K,
            "rounds": len(ms),
            "round_ms_min": round(float(ms[0]), 2),
            "round_ms_p50": round(float(ms[len(ms) // 2]), 2),
            "compile_s": round(compile_s, 1),
            "digest": dg,
            "viterbi": args.viterbi, "chainback": args.chainback,
            "block_tracking": bool(args.block_tracking),
        }
        results[stage] = rec
        print(json.dumps(rec), flush=True)

    # deltas between successive landed stages, in canonical order
    landed = [s for s in ALL_STAGES if s in results]
    deltas = {}
    for a, b in zip(landed, landed[1:]):
        deltas[f"{b}-{a}"] = round(results[b]["round_ms_p50"]
                                   - results[a]["round_ms_p50"], 2)
    if landed:
        print(json.dumps({
            "metric": "fused_stage_ablation_summary",
            "streams": N, "frames_per_round": K,
            "p50_ms": {s: results[s]["round_ms_p50"] for s in landed},
            "deltas_ms": deltas,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
