"""Weak-scaling harness for the mesh-sharded demod (N-device scaling
efficiency).

Runs the data-parallel sharded frame step at n_devices in {1,2,4,8} with the
per-device batch held constant (weak scaling over the 'ens' axis) and
reports frames/s + parallel efficiency vs the 1-device run.

On this image only virtual CPU devices are available
(--xla_force_host_platform_device_count), which share the same cores — the
printed efficiency therefore measures sharding/collective overhead, not
real cross-card scaling; run unchanged on a multi-GPU host for the true
number.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/bench_scaling.py [--per-device-batch 4] [--iters 10]
       [--full-chain]   # weak-scale the FULL sharded receiver step
                        # (demod+FIC+deinterleave+MSC) over the 'ens' axis
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-device-batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", type=int, default=2)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--backend", default="cpu", choices=["default", "cpu"])
    ap.add_argument("--full-chain", action="store_true",
                    help="scale multichip_receiver_step (the whole decode "
                         "chain) instead of the demod-only step")
    args = ap.parse_args(argv)
    if args.backend == "cpu":
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from dab_radio_tpu.models.demodulator import OFDMDemodulator, DemodCarry
    from dab_radio_tpu.parallel.mesh import shard_demod_batch

    avail = len(jax.devices())
    demod = OFDMDemodulator(args.mode)
    rng = np.random.default_rng(0)
    results = []
    base = None

    if args.full_chain:
        from dab_radio_tpu.parallel.mesh import multichip_receiver_step
        for n in [int(x) for x in args.devices.split(",") if int(x) <= avail]:
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1, 1),
                        ("ens", "time", "sub"))
            step, (carry, hist, iq) = multichip_receiver_step(
                mesh, transmission_mode=args.mode,
                ensembles_per_shard=args.per_device_batch)
            B = n * args.per_device_batch
            carry, hist, out = step(carry, hist, iq)       # compile
            jax.block_until_ready(out["msc_bits"])
            t0 = time.time()
            c, h = carry, hist
            for _ in range(args.iters):
                c, h, out = step(c, h, iq)
            jax.block_until_ready(out["msc_bits"])
            float(np.asarray(out["fic_err"]).sum())
            dt = time.time() - t0
            fps = B * args.iters / dt                      # frames/s (1/step)
            if base is None:
                base = fps / n
            eff = fps / (n * base)
            results.append({"devices": n, "batch": B,
                            "frames_per_s": round(fps, 1),
                            "efficiency": round(eff, 3)})
            print(f"# full-chain n={n} B={B} {fps:.1f} frames/s "
                  f"eff={eff:.3f}", file=sys.stderr)
        print(json.dumps({"metric": "receiver_weak_scaling",
                          "mode": args.mode, "points": results}))
        return 0

    for n in [int(x) for x in args.devices.split(",") if int(x) <= avail]:
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1, 1),
                    ("ens", "time", "sub"))
        step, win_sh, carry_sh = shard_demod_batch(demod, mesh)
        B = n * args.per_device_batch
        wins = jax.device_put(
            jnp.asarray(rng.normal(0, .5, (B, demod.window_len, 2))
                        .astype(np.float32)), win_sh)
        carry = jax.device_put(DemodCarry.init((B,)), carry_sh)
        carry, out = step(carry, wins)           # compile
        jax.block_until_ready(out["bits"])
        t0 = time.time()
        c = carry
        for _ in range(args.iters):
            c, out = step(c, wins)
        jax.block_until_ready(out["bits"])
        float(np.asarray(c.freq_fine.astype(jnp.float32)).sum())
        dt = time.time() - t0
        fps = B * args.iters / dt
        if base is None:
            base = fps / n
        eff = fps / (n * base)
        results.append({"devices": n, "batch": B,
                        "frames_per_s": round(fps, 1),
                        "efficiency": round(eff, 3)})
        print(f"# n={n} B={B} {fps:.1f} frames/s eff={eff:.3f}",
              file=sys.stderr)
    print(json.dumps({"metric": "demod_weak_scaling", "mode": args.mode,
                      "points": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
