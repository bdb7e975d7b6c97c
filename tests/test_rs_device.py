"""Device (XLA) Reed-Solomon syndrome path: one binary matmul + parity.

Gate contract: clean codewords -> all-zero syndromes on device; corrupted
rows match the host syndrome computation exactly, so the host BM/Forney
tail sees identical inputs.
"""

import numpy as np
import jax

from dab_radio_tpu.ops import rs


def test_device_syndromes_match_host():
    rng = np.random.default_rng(3)
    for nroots, pad in ((10, 135), (16, 51)):   # DAB+ RS(120,110), packet RS(204,188)
        n = 255 - pad
        cw = rng.integers(0, 256, (64, n)).astype(np.uint8)
        host = rs.rs_syndromes_numpy(cw, nroots, pad)
        dev = np.asarray(jax.jit(
            lambda x, r=nroots, p=pad: rs.rs_syndromes_device(x, r, p))(cw))
        np.testing.assert_array_equal(host, dev)


def test_device_syndromes_gate():
    rng = np.random.default_rng(4)
    nroots, pad = 10, 135
    n = 255 - pad
    msg = rng.integers(0, 256, (16, n - nroots)).astype(np.uint8)
    enc = np.stack([rs.rs_encode(m, nroots, pad) for m in msg])
    syn = np.asarray(rs.rs_syndromes_device(enc, nroots, pad))
    assert not syn.any()                      # clean -> gate stays closed
    bad = enc.copy()
    bad[3, 7] ^= 0x55
    bad[9, 100] ^= 0x01
    syn = np.asarray(rs.rs_syndromes_device(bad, nroots, pad))
    fired = syn.any(axis=-1)
    assert fired[3] and fired[9] and fired.sum() == 2
    # and the host decoder corrects exactly those rows
    fixed, nerr = rs.dab_plus_rs().decode(bad)
    np.testing.assert_array_equal(fixed, enc)
    assert nerr[3] == 1 and nerr[9] == 1
