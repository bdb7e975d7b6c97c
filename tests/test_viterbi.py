"""Viterbi codec tests: encode/puncture/decode round trips, noise robustness,
batching, and the FIC bit budget."""

import numpy as np
import jax.numpy as jnp
import pytest

from dab_radio_tpu.ops import viterbi as vit
from dab_radio_tpu.ops.scrambler import prbs_bytes, descramble
from dab_radio_tpu.ops.crc import crc16, crc16_check, firecode_crc16
from dab_radio_tpu.params import fic_puncture_schedule
from dab_radio_tpu.params.puncture import build_puncture_mask, get_puncture_vector, PI_X_VECTOR


def _roundtrip(bits, schedule, rng=None, flip=0):
    coded = vit.conv_encode(bits)
    mask = build_puncture_mask(schedule)
    assert coded.shape[0] == mask.shape[0]
    tx = vit.puncture(coded, mask)
    soft = vit.bits_to_soft(tx).astype(np.int8)
    if flip:
        idx = rng.choice(soft.shape[0], size=flip, replace=False)
        soft[idx] = -soft[idx]
    spec = vit.ViterbiSpec.from_schedule(schedule)
    dec, err = vit.viterbi_decode(jnp.asarray(soft), spec)
    return np.asarray(dec), int(err)


def test_encoder_basics():
    # all-zero input -> all-zero output, trellis stays at state 0
    out = vit.conv_encode(np.zeros(10, dtype=np.uint8))
    assert out.shape == (16 * 4,)
    assert not out.any()
    # single 1 produces the impulse response of the code
    out = vit.conv_encode(np.array([1, 0, 0, 0, 0, 0, 0], dtype=np.uint8),
                          append_tail=False)
    # first step: reg = 1000000b, taps g0: octal 133 has MSB tap set
    assert out[:4].tolist() == [1, 1, 1, 1]


def test_fic_roundtrip_clean():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=768).astype(np.uint8)
    sched = fic_puncture_schedule()
    dec, err = _roundtrip(bits, sched)
    assert dec.shape == (768,)
    np.testing.assert_array_equal(dec, bits)
    # clean-channel path error = 127 per punctured (zero-fed) mother symbol,
    # matching the reference decoder's metric semantics
    nb_punctured = 3096 - 2304
    assert err == nb_punctured * 127


def test_fic_roundtrip_with_errors():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=768).astype(np.uint8)
    sched = fic_puncture_schedule()
    # flip 100 of the 2304 transmitted symbols: rate-1/3 K=7 corrects this
    dec, err = _roundtrip(bits, sched, rng=rng, flip=100)
    np.testing.assert_array_equal(dec, bits)
    assert err > 0


def test_roundtrip_eep_schedule():
    from dab_radio_tpu.params import msc_puncture_schedule, SubchannelConfig
    cfg = SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)  # 64kbps 3-A
    sched = msc_puncture_schedule(cfg)
    spec = vit.ViterbiSpec.from_schedule(sched)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, size=spec.nb_data_bits).astype(np.uint8)
    dec, err = _roundtrip(bits, sched, rng=rng, flip=40)
    np.testing.assert_array_equal(dec, bits)


def test_batched_decode():
    sched = fic_puncture_schedule()
    spec = vit.ViterbiSpec.from_schedule(sched)
    rng = np.random.default_rng(3)
    B = 4
    bits = rng.integers(0, 2, size=(B, 768)).astype(np.uint8)
    mask = build_puncture_mask(sched)
    soft = np.stack([vit.bits_to_soft(vit.puncture(vit.conv_encode(b), mask))
                     for b in bits])
    dec, err = vit.viterbi_decode(jnp.asarray(soft), spec)
    np.testing.assert_array_equal(np.asarray(dec), bits)
    assert err.shape == (B,)


def test_soft_decisions_help():
    """Attenuated-but-correct soft symbols should still decode."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, size=768).astype(np.uint8)
    sched = fic_puncture_schedule()
    coded = vit.conv_encode(bits)
    tx = vit.puncture(coded, build_puncture_mask(sched))
    soft = vit.bits_to_soft(tx).astype(np.float32)
    noisy = soft + rng.normal(0, 80, size=soft.shape)
    soft_q = np.clip(noisy, -127, 127).astype(np.int8)
    spec = vit.ViterbiSpec.from_schedule(sched)
    dec, _ = vit.viterbi_decode(jnp.asarray(soft_q), spec)
    np.testing.assert_array_equal(np.asarray(dec), bits)


def test_prbs_scrambler():
    p = prbs_bytes(16)
    # involution: descramble twice = identity
    data = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(descramble(descramble(data)), data)
    # first PRBS byte from all-ones register: known value 0xFF? compute manually
    reg = 0x1FF
    b = 0
    for j in range(8):
        v = ((reg >> 8) ^ (reg >> 4)) & 1
        b |= v << (7 - j)
        reg = ((reg << 1) | v) & 0xFFFF
    assert p[0] == b


def test_crc16_known_vector():
    # CCITT-FALSE("123456789") = 0x29B1; DAB FIB adds final xor 0xFFFF
    assert crc16(b"123456789", final_xor=0x0000) == 0x29B1
    buf = bytearray(b"123456789")
    c = crc16(bytes(buf))
    buf += bytes([(c >> 8) & 0xFF, c & 0xFF])
    assert crc16_check(bytes(buf))


def test_firecode_nonzero():
    assert firecode_crc16(b"\x00" * 9) == 0
    assert firecode_crc16(b"\x01" + b"\x00" * 8) != 0


def test_radix4_matches_radix2_exactly():
    """The fused two-step decode must be bit-identical to the sequential
    scan, including argmin tie-breaking, on heavily corrupted input."""
    from dab_radio_tpu.params import msc_puncture_schedule, SubchannelConfig
    from dab_radio_tpu.params.puncture import build_puncture_mask
    rng = np.random.default_rng(11)
    cfgs = [
        SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
        SubchannelConfig(0, 42, False, eep_type="B", eep_prot_level=1),
        SubchannelConfig(0, 84, True, uep_table_index=33),
    ]
    for cfg in cfgs:
        spec = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(cfg))
        assert spec.nb_steps % 2 == 0
        mask = build_puncture_mask(msc_puncture_schedule(cfg))
        B = 6
        bits = rng.integers(0, 2, size=(B, spec.nb_data_bits)).astype(np.uint8)
        soft = np.stack([
            vit.bits_to_soft(vit.puncture(vit.conv_encode(b), mask))
            for b in bits]).astype(np.int32)
        # strong noise + saturated ties to stress tie-breaking
        noise = rng.integers(-120, 121, size=soft.shape)
        soft = np.clip(soft + noise, -127, 127).astype(np.int8)
        soft[rng.random(soft.shape) < 0.05] = 0

        d = vit.depuncture(jnp.asarray(soft), spec)
        b2, e2 = vit.viterbi_decode_soft(d)
        b4, e4 = vit.viterbi_decode_soft_radix4(d)
        np.testing.assert_array_equal(np.asarray(b4), np.asarray(b2))
        np.testing.assert_array_equal(np.asarray(e4), np.asarray(e2))
        # LUT branch metrics (16-sum factorization + static gather) must
        # be bit-identical incl. ties and path error — same candidates,
        # different arithmetic route (the ACS roofline A/B lever)
        bl, el = vit.viterbi_decode_soft_radix4(d, branch="lut")
        np.testing.assert_array_equal(np.asarray(bl), np.asarray(b2))
        np.testing.assert_array_equal(np.asarray(el), np.asarray(e2))
        # LUT must compose with the register-exchange chainback too (the
        # serving lever matrix crosses them; a dropped branch= here once
        # mislabeled an A/B)
        bf, ef = vit.viterbi_decode_soft_radix4(d, branch="lut",
                                                chainback="fused")
        np.testing.assert_array_equal(np.asarray(bf), np.asarray(b2))
        np.testing.assert_array_equal(np.asarray(ef), np.asarray(e2))


def test_radix8_matches_radix2_exactly():
    """The fused three-step decode must be bit-identical to the sequential
    scan, including argmin tie-breaking, on heavily corrupted input.

    (Radix-8 doubles the per-iteration candidate volume; it exists for
    iteration-count-bound regimes like the fused fleet round. Its speed on
    the H100 is not measured yet. Kept bit-exact either way.)"""
    rng = np.random.default_rng(17)
    L, B = 504, 6                      # T = L + 6 = 510, divisible by 2 and 3
    bits = rng.integers(0, 2, size=(B, L)).astype(np.uint8)
    soft = np.stack([
        vit.bits_to_soft(vit.conv_encode(b)).reshape(-1, 4)
        for b in bits]).astype(np.int32)
    noise = rng.integers(-120, 121, size=soft.shape)
    soft = np.clip(soft + noise, -127, 127).astype(np.int8)
    soft[rng.random(soft.shape) < 0.05] = 0

    d = jnp.asarray(soft)
    b2, e2 = vit.viterbi_decode_soft(d)
    b8, e8 = vit.viterbi_decode_soft_radix8(d)
    np.testing.assert_array_equal(np.asarray(b8), np.asarray(b2))
    np.testing.assert_array_equal(np.asarray(e8), np.asarray(e2))


def test_tiled_matches_full_decode():
    """Tiled (overlap-save) decode equals the full decode on clean input and
    at operating SNR; BER stays close under heavy noise."""
    from dab_radio_tpu.params import msc_puncture_schedule, SubchannelConfig
    from dab_radio_tpu.params.puncture import build_puncture_mask
    rng = np.random.default_rng(21)
    cfg = SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)
    spec = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(cfg))
    mask = build_puncture_mask(msc_puncture_schedule(cfg))
    B = 16
    bits = rng.integers(0, 2, size=(B, spec.nb_data_bits)).astype(np.uint8)
    clean = np.stack([
        vit.bits_to_soft(vit.puncture(vit.conv_encode(b), mask))
        for b in bits]).astype(np.int32)

    # clean: exact
    t_bits, _ = vit.viterbi_decode_tiled(jnp.asarray(clean.astype(np.int8)),
                                         spec)
    np.testing.assert_array_equal(np.asarray(t_bits), bits)

    # operating SNR (full decode recovers everything): tiled must agree
    noisy = np.clip(clean + rng.normal(0, 35, clean.shape), -127, 127
                    ).astype(np.int8)
    f_bits, _ = vit.viterbi_decode(jnp.asarray(noisy), spec)
    assert (np.asarray(f_bits) == bits).all(), "full decode failed; raise SNR"
    t_bits, _ = vit.viterbi_decode_tiled(jnp.asarray(noisy), spec)
    np.testing.assert_array_equal(np.asarray(t_bits), np.asarray(f_bits))

    # heavy noise: BER within 1% absolute of the full decode
    heavy = np.clip(clean + rng.normal(0, 110, clean.shape), -127, 127
                    ).astype(np.int8)
    f_bits, _ = vit.viterbi_decode(jnp.asarray(heavy), spec)
    t_bits, _ = vit.viterbi_decode_tiled(jnp.asarray(heavy), spec)
    ber_f = float((np.asarray(f_bits) != bits).mean())
    ber_t = float((np.asarray(t_bits) != bits).mean())
    assert abs(ber_t - ber_f) < 0.01, (ber_f, ber_t)


def test_parallel_chainback_matches_sequential():
    """The log-depth map-composition chainback must be bit-identical to the
    sequential traceback walk for every decoder that offers it (radix-4,
    radix-8, tiled), on heavily corrupted input with saturated ties.

    Pointer composition is pure index algebra, so this is exact by
    construction — the test pins the composition ORDER (suffix scan with
    reverse=True feeds later elements first) and the bit extraction."""
    rng = np.random.default_rng(29)
    for L in (48, 378, 1018):          # T = L+6: covers odd/even Tr, radix-8
        B = 5
        bits = rng.integers(0, 2, size=(B, L)).astype(np.uint8)
        soft = np.stack([
            vit.bits_to_soft(vit.conv_encode(b)).reshape(-1, 4)
            for b in bits]).astype(np.int32)
        noise = rng.integers(-120, 121, size=soft.shape)
        soft = np.clip(soft + noise, -127, 127).astype(np.int8)
        soft[rng.random(soft.shape) < 0.05] = 0
        d = jnp.asarray(soft)

        bs, es = vit.viterbi_decode_soft_radix4(d)
        bp, ep = vit.viterbi_decode_soft_radix4(d, chainback="parallel")
        np.testing.assert_array_equal(np.asarray(bp), np.asarray(bs))
        np.testing.assert_array_equal(np.asarray(ep), np.asarray(es))

        if (L + 6) % 3 == 0:
            b8s, _ = vit.viterbi_decode_soft_radix8(d)
            b8p, _ = vit.viterbi_decode_soft_radix8(d, chainback="parallel")
            np.testing.assert_array_equal(np.asarray(b8p), np.asarray(b8s))

        ts, _ = vit.viterbi_decode_soft_tiled(d)
        tp, _ = vit.viterbi_decode_soft_tiled(d, chainback="parallel")
        np.testing.assert_array_equal(np.asarray(tp), np.asarray(ts))


def test_parallel_chainback_through_punctured_decode():
    """viterbi_decode(chainback="parallel") round-trips a punctured EEP
    schedule identically to the default path."""
    from dab_radio_tpu.params import msc_puncture_schedule, SubchannelConfig
    from dab_radio_tpu.params.puncture import build_puncture_mask
    rng = np.random.default_rng(31)
    cfg = SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)
    spec = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(cfg))
    mask = build_puncture_mask(msc_puncture_schedule(cfg))
    bits = rng.integers(0, 2, size=(4, spec.nb_data_bits)).astype(np.uint8)
    soft = np.stack([
        vit.bits_to_soft(vit.puncture(vit.conv_encode(b), mask))
        for b in bits])
    noisy = np.clip(soft.astype(np.int32)
                    + rng.integers(-60, 61, soft.shape), -127, 127
                    ).astype(np.int8)
    bs, es = vit.viterbi_decode(jnp.asarray(noisy), spec)
    bp, ep = vit.viterbi_decode(jnp.asarray(noisy), spec,
                                chainback="parallel")
    np.testing.assert_array_equal(np.asarray(bp), np.asarray(bs))
    np.testing.assert_array_equal(np.asarray(ep), np.asarray(es))
    np.testing.assert_array_equal(np.asarray(bs), bits)


def test_long_trellis_exactness_radix4_and_radix8():
    """Regression (self-review round 3): high-bitrate subchannels reach
    9222+ trellis steps per CIF, where absolute path metrics drift to
    ~|508*T| ~ 4.7M and a naive packed 4*m+p min would exceed f32
    exactness (2^24). The per-step rebasing in the state-major forward
    passes must keep radix-4/radix-8 bit-identical to the int32
    sequential decoder at these lengths."""
    rng = np.random.default_rng(41)
    L = 9216                       # T = L+6 = 9222 (UEP 384 kbps scale)
    B = 2
    bits = rng.integers(0, 2, size=(B, L)).astype(np.uint8)
    soft = np.stack([
        vit.bits_to_soft(vit.conv_encode(b)).reshape(-1, 4)
        for b in bits]).astype(np.int32)
    noise = rng.integers(-100, 101, size=soft.shape)
    soft = np.clip(soft + noise, -127, 127).astype(np.int8)
    soft[rng.random(soft.shape) < 0.05] = 0
    d = jnp.asarray(soft)

    b2, e2 = vit.viterbi_decode_soft(d)       # int32 metrics: exact oracle
    b4, e4 = vit.viterbi_decode_soft_radix4(d)
    np.testing.assert_array_equal(np.asarray(b4), np.asarray(b2))
    np.testing.assert_array_equal(np.asarray(e4), np.asarray(e2))
    b4p, _ = vit.viterbi_decode_soft_radix4(d, chainback="parallel")
    np.testing.assert_array_equal(np.asarray(b4p), np.asarray(b2))
    b8, e8 = vit.viterbi_decode_soft_radix8(d)
    np.testing.assert_array_equal(np.asarray(b8), np.asarray(b2))
    np.testing.assert_array_equal(np.asarray(e8), np.asarray(e2))


def test_fused_register_exchange_matches_sequential():
    """chainback="fused" (register exchange: decoded bits ride the forward
    scan as packed words, no traceback scan at all) must be bit-identical
    to the sequential chainback for radix-4 and tiled decodes, on heavily
    corrupted input with saturated ties — the survivor selection is the
    same packed-min ACS, so any divergence is a history-permutation or
    bit-packing bug."""
    rng = np.random.default_rng(31)
    for L in (42, 378, 1018):          # word-boundary coverage: T=48 (1.5
        B = 5                          # words), 384 (12), 1024 (32 exact)
        bits = rng.integers(0, 2, size=(B, L)).astype(np.uint8)
        soft = np.stack([
            vit.bits_to_soft(vit.conv_encode(b)).reshape(-1, 4)
            for b in bits]).astype(np.int32)
        noise = rng.integers(-120, 121, size=soft.shape)
        soft = np.clip(soft + noise, -127, 127).astype(np.int8)
        soft[rng.random(soft.shape) < 0.05] = 0
        d = jnp.asarray(soft)

        bs, es = vit.viterbi_decode_soft_radix4(d)
        bf, ef = vit.viterbi_decode_soft_radix4(d, chainback="fused")
        np.testing.assert_array_equal(np.asarray(bf), np.asarray(bs))
        np.testing.assert_array_equal(np.asarray(ef), np.asarray(es))

        ts, _ = vit.viterbi_decode_soft_tiled(d)
        tf, _ = vit.viterbi_decode_soft_tiled(d, chainback="fused")
        np.testing.assert_array_equal(np.asarray(tf), np.asarray(ts))


def test_fused_register_exchange_clean_roundtrip():
    """Clean encode->decode through the register-exchange path recovers the
    payload exactly (end-state anchored decode, tail bits dropped)."""
    rng = np.random.default_rng(33)
    bits = rng.integers(0, 2, size=(3, 250)).astype(np.uint8)
    soft = np.stack([
        vit.bits_to_soft(vit.conv_encode(b)).reshape(-1, 4)
        for b in bits]).astype(np.int32)
    out, err = vit.viterbi_decode_soft_radix4(
        jnp.asarray(soft), chainback="fused")
    np.testing.assert_array_equal(np.asarray(out)[:, :250], bits)
    assert np.all(np.asarray(err) == 0)
