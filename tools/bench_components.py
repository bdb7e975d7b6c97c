"""Component-level benchmarks: OFDM demod, Viterbi, RS, deinterleave.

Secondary to bench.py; gives per-kernel numbers (Msamples/s demod, Mbit/s
Viterbi on the FIC shape, host RS decode MB/s). Each timing ends in
block_until_ready.

Usage: python tools/bench_components.py [--platform cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_demod(batch=32, iters=20):
    import numpy as np
    import jax, jax.numpy as jnp
    from dab_radio_tpu.models.demodulator import OFDMDemodulator, DemodCarry
    demod = OFDMDemodulator(1)
    rng = np.random.default_rng(0)
    win = rng.normal(0, .5, (batch, demod.window_len, 2)).astype(np.float32)
    wins = jax.device_put(jnp.asarray(win))
    c, out = demod.frame_step_batch(DemodCarry.init((batch,)), wins)
    jax.block_until_ready(out["bits"])
    t0 = time.time()
    for _ in range(iters):
        c, out = demod.frame_step_batch(c, wins)
    jax.block_until_ready((c, out["bits"]))
    dt = time.time() - t0
    msps = batch * demod.params.nb_frame_samples * iters / dt / 1e6
    print(f"ofdm_demod: batch={batch} {msps:.1f} Msamples/s "
          f"({msps / 2.048:.1f} realtime ensembles)")


def bench_viterbi(batch=64, iters=10):
    import numpy as np
    import jax, jax.numpy as jnp
    from dab_radio_tpu.ops import viterbi as vit
    from dab_radio_tpu.params import fic_puncture_schedule
    spec = vit.ViterbiSpec.from_schedule(fic_puncture_schedule())
    rng = np.random.default_rng(0)
    soft = jnp.asarray(rng.integers(-127, 128, (batch, spec.nb_in)), jnp.int8)
    fn = jax.jit(lambda s: vit.viterbi_decode(s, spec)[0])
    jax.block_until_ready(fn(soft))
    t0 = time.time()
    for _ in range(iters):
        bits = fn(soft)
    jax.block_until_ready(bits)
    dt = time.time() - t0
    mbps = batch * spec.nb_data_bits * iters / dt / 1e6
    print(f"viterbi_scan: batch={batch} {mbps:.1f} Mbit/s decoded "
          f"({batch * spec.nb_in * iters / dt / 1e6:.1f} Msym/s in)")


def bench_rs(iters=5):
    import numpy as np
    from dab_radio_tpu.ops.rs import dab_plus_rs, rs_encode
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 256, (256, 110)).astype(np.uint8)
    cw = rs_encode(msgs, 10, 135)
    dec = dab_plus_rs()
    t0 = time.time()
    for _ in range(iters):
        out, nerr = dec.decode(cw)
    dt = time.time() - t0
    mbs = cw.size * iters / dt / 1e6
    print(f"reed_solomon(clean): {mbs:.1f} MB/s over {cw.shape[0]} codewords")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    print(f"devices: {jax.devices()}")
    bench_demod()
    bench_viterbi()
    bench_rs()


if __name__ == "__main__":
    main()
