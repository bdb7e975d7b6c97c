"""Mesh sharding tests on the 8-device virtual CPU mesh: the time-sharded
(sequence-parallel, ppermute halo) demod must produce the same bits as the
sequential streaming demodulator."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dab_radio_tpu.models import OFDMModulator, OFDMDemodulator, DemodCarry
from dab_radio_tpu.ops.iq import iq_pairs
from dab_radio_tpu.parallel.mesh import (
    make_receiver_mesh, make_timesharded_demod, multichip_receiver_step,
    shard_demod_batch,
)
from jax.sharding import NamedSharding, PartitionSpec as P


def test_mesh_factorisation():
    mesh = make_receiver_mesh(8)
    assert dict(mesh.shape) == {"ens": 2, "time": 2, "sub": 2}
    mesh4 = make_receiver_mesh(4)
    assert np.prod(list(mesh4.shape.values())) == 4


def test_timesharded_demod_matches_sequential():
    mode = 2
    mod = OFDMModulator(mode)
    demod = OFDMDemodulator(mode)
    mesh = make_receiver_mesh(8)
    n_time = mesh.shape["time"]
    f_loc = 2
    F = n_time * f_loc
    B = 4

    rng = np.random.default_rng(0)
    p = mod.params
    bits_tx = rng.integers(
        0, 2, size=(B, F, p.nb_data_symbols, 2 * p.nb_data_carriers)
    ).astype(np.uint8)
    iq = np.asarray(jax.vmap(mod.modulate_stream)(jnp.asarray(bits_tx)))
    assert iq.shape == (B, F * p.nb_frame_samples)

    fn = make_timesharded_demod(demod, mesh, f_loc)
    carry = DemodCarry.init((B, n_time))
    carry = carry._replace(
        signal_l1_avg=jnp.full((B, n_time), 0.5, jnp.float32))
    iq_sharded = jax.device_put(jnp.asarray(iq_pairs(iq)),
                                NamedSharding(mesh, P("ens", "time")))
    carry2, bits, _ = fn(carry, iq_sharded)
    bits = np.asarray(bits).reshape(B, F, -1)

    hard = (bits > 0).astype(np.uint8)
    ref = bits_tx.reshape(B, F, -1)
    # phase-aligned signal: offset stays 0, so the zero end-of-stream tail
    # is never read and the whole block demodulates exactly
    np.testing.assert_array_equal(hard, ref)


def test_timesharded_demod_positive_offset_needs_tail():
    """Real sample-clock drift pushes the fine-time offset positive, making
    the LAST frame's body read into the window margin past the block end.
    With the stream tail supplied (the next block's head) the decode stays
    exact; the old zero-halo behavior corrupted that frame every block."""
    mode = 2
    mod = OFDMModulator(mode)
    demod = OFDMDemodulator(mode)
    mesh = make_receiver_mesh(8)
    n_time = mesh.shape["time"]
    f_loc = 2
    F = n_time * f_loc
    B = 2
    d = 120          # positive timing offset: inside the mode-2 cyclic
    #                  prefix (126) so tracking stays locked, but zeroing
    #                  120 of the last FFT window's 512 samples corrupts it

    rng = np.random.default_rng(3)
    p = mod.params
    bits_tx = rng.integers(
        0, 2, size=(B, F + 1, p.nb_data_symbols, 2 * p.nb_data_carriers)
    ).astype(np.uint8)
    iq_all = np.asarray(jax.vmap(mod.modulate_stream)(jnp.asarray(bits_tx)))
    T = F * p.nb_frame_samples
    # feed the block starting d samples EARLY: every frame begins at +d
    # inside its window, so the last frame's body needs d samples past T
    lead = np.zeros((B, d), np.complex64)
    stream = np.concatenate([lead, iq_all], axis=1)
    blk = stream[:, :T]
    halo = demod.window_len - p.nb_frame_samples
    tail = stream[:, T:T + halo]

    fn = make_timesharded_demod(demod, mesh, f_loc)

    def run(tail_arg):
        carry = DemodCarry.init((B, n_time))._replace(
            signal_l1_avg=jnp.full((B, n_time), 0.5, jnp.float32))
        _, bits, _ = fn(carry, jax.device_put(
            jnp.asarray(iq_pairs(blk)),
            NamedSharding(mesh, P("ens", "time"))), tail_arg)
        return (np.asarray(bits).reshape(B, F, -1) > 0).astype(np.uint8)

    ref = bits_tx[:, :F].reshape(B, F, -1)
    with_tail = run(jnp.asarray(iq_pairs(tail)))
    np.testing.assert_array_equal(with_tail, ref)
    # and the zero-tail decode must demonstrate the bug class this guards
    # against: the final frame differs (margin read zeros)
    without = run(None)
    np.testing.assert_array_equal(without[:, :F - 1], ref[:, :F - 1])
    assert (without[:, F - 1] != ref[:, F - 1]).any(), \
        "zero tail unexpectedly decoded the last frame exactly"


def test_shard_demod_batch_runs():
    demod = OFDMDemodulator(2)
    mesh = make_receiver_mesh(8)
    step, win_sh, carry_sh = shard_demod_batch(demod, mesh)
    B = 8
    rng = np.random.default_rng(1)
    wins = jax.device_put(
        jnp.asarray(rng.normal(0, 1, (B, demod.window_len, 2))
                    .astype(np.float32)), win_sh)
    carry = jax.device_put(DemodCarry.init((B,)), carry_sh)
    carry, out = step(carry, wins)
    assert out["bits"].shape == (B, demod.params.nb_frame_bits)


def test_multichip_receiver_step_compiles_and_runs():
    mesh = make_receiver_mesh(8)
    step, args = multichip_receiver_step(mesh, transmission_mode=2)
    carry, hist, out = step(*args)
    jax.block_until_ready(out["msc_bits"])
    assert out["fib_bits"].shape[-1] == 768


def test_multichip_receiver_step_stop_after_stages():
    """stop_after truncation (the round-5 per-stage timing ablation,
    tools/bench_stages.py): every rung compiles, returns a finite scalar
    digest, and keeps the carry/hist tree shapes so rounds chain."""
    import numpy as np
    mesh = make_receiver_mesh(1, axis_sizes=(1, 1, 1))
    shapes = None
    for stage in ("ingest", "demod", "subs", "deint", "depunct", "acs"):
        step, (carry, hist, iq) = multichip_receiver_step(
            mesh, transmission_mode=2, frames_per_shard=1,
            ensembles_per_shard=1, subchannels_per_shard=1,
            ingest="u8", fuse_fic=True, stop_after=stage)
        assert step.stop_after == stage
        c2, h2, out = step(carry, hist, iq)
        assert set(out) == {"digest"}
        assert np.isfinite(float(np.asarray(out["digest"])))
        got = [x.shape for x in jax.tree_util.tree_leaves((c2, h2))]
        want = [x.shape for x in jax.tree_util.tree_leaves((carry, hist))]
        assert got == want, stage
        if shapes is None:
            shapes = want
        assert shapes == want


@pytest.mark.slow
def test_multichip_end_to_end_bit_exact():
    """The full dryrun contract: sharded demod->FIC->MSC over a real
    modulated ensemble equals the single-device host path bit-for-bit."""
    import __graft_entry__ as graft
    graft.dryrun_multichip(8)


def test_coldstart_timesharded_acquisition():
    """From a COLD carry and a random signal
    offset, the time-sharded demod must acquire (local null-dip search +
    global election + phase broadcast) and converge to the sequential
    StreamingDemodulator's frames within the first frame round."""
    from dab_radio_tpu.models.demodulator import StreamingDemodulator
    from dab_radio_tpu.parallel.mesh import make_coldstart_timesharded_demod

    mode = 2
    mod = OFDMModulator(mode)
    demod = OFDMDemodulator(mode)
    mesh = make_receiver_mesh(8)
    n_time = mesh.shape["time"]
    f_loc = 6
    p = mod.params
    fs = p.nb_frame_samples
    T_tot = n_time * f_loc * fs
    B = 2

    rng = np.random.default_rng(7)
    streams, tx_bits = [], []
    for b in range(B):
        offset = int(rng.integers(fs // 4, fs))
        nb_frames = (T_tot - offset) // fs + 1
        bits = rng.integers(0, 2, (nb_frames, p.nb_data_symbols,
                                   2 * p.nb_data_carriers)).astype(np.uint8)
        iq = np.asarray(mod.modulate_stream(jnp.asarray(bits)))
        lead = (rng.normal(0, 0.01, offset)
                + 1j * rng.normal(0, 0.01, offset)).astype(np.complex64)
        streams.append(np.concatenate([lead, iq])[:T_tot])
        tx_bits.append(bits)
    streams = np.stack(streams)

    fn = make_coldstart_timesharded_demod(demod, mesh, f_loc)
    iq_sharded = jax.device_put(
        jnp.asarray(iq_pairs(streams)),
        NamedSharding(mesh, P("ens", "time")))
    carry, bits_out, valid = fn(iq_sharded)
    bits_out = np.asarray(bits_out).reshape(B, n_time * f_loc, -1)
    valid = np.asarray(valid).reshape(B, n_time * f_loc)

    for b in range(B):
        sd = StreamingDemodulator(demod)
        seq_frames = sd.process(streams[b])
        mesh_frames = [bits_out[b, i] for i in range(valid.shape[1])
                       if valid[b, i]]
        assert len(seq_frames) >= n_time * f_loc - 3
        # cold-start sharded acquisition reproduces the sequential decode
        # (the tail may lose up to one frame per stream to the zero halo)
        assert len(mesh_frames) >= len(seq_frames) - 2
        for mf, sf in zip(mesh_frames, seq_frames):
            np.testing.assert_array_equal(mf > 0, np.asarray(sf) > 0)


def test_multichip_heterogeneous_subchannels_bit_exact():
    """ONE padded sharded program decodes mixed EEP-A / UEP / EEP-B
    subchannels bit-identically to the per-subchannel host decoders
    (reference msc_decoder.cpp:77-154)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dab_radio_tpu.parallel.mesh import (make_receiver_mesh,
                                             multichip_receiver_step)
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.params import SubchannelConfig, get_dab_params
    from dab_radio_tpu.dab.msc import MSCDecoder
    from dab_radio_tpu.ops.iq import iq_pairs

    mode = 2
    dab = get_dab_params(mode)
    mesh = make_receiver_mesh(4, axis_sizes=(1, 2, 2))
    F = 20
    shapes = [
        SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
        SubchannelConfig(12, 16, True, uep_table_index=0),
        SubchannelConfig(28, 21, False, eep_type="B", eep_prot_level=1),
        SubchannelConfig(49, 12, False, eep_type="A", eep_prot_level=0),
    ]
    step, (carry, hist, _) = multichip_receiver_step(
        mesh, mode, F // 2, subchannels_per_shard=2,
        ensembles_per_shard=1, subchannel_cfgs=shapes)

    tx = EnsembleTransmitter(
        mode, ensemble_id=0xC0AA, ensemble_label="HET",
        services=[ServiceSpec(0xF000 + s, s, f"S{s}", shapes[s])
                  for s in range(4)])
    fb, fi = [], []
    for _ in range(F):
        fb.append(np.asarray(tx.next_frame_bits()))
        fi.append(tx.modulate_frame_bits(fb[-1]))
    frame_bits = np.stack(fb)[None]
    iq = np.concatenate(fi)[None]

    iq_sharded = jax.device_put(jnp.asarray(iq_pairs(iq)),
                                NamedSharding(mesh, P("ens", "time")))
    carry, hist, out = step(carry, hist, iq_sharded)
    msc_bits = np.asarray(jax.device_get(out["msc_bits"]))

    warm = 16
    for s, cfg in enumerate(shapes):
        dec = MSCDecoder(cfg)
        cifs = frame_bits[0, :, dab.nb_fic_bits:].reshape(
            F * dab.nb_cifs, dab.nb_cif_bits)
        nb = step.msc_nb_data_bits[s]
        for c in range(F * dab.nb_cifs):
            ref = dec.decode_cif(cifs[c])
            if c < warm:
                continue
            got = np.packbits(msc_bits[0, s, c][:nb].astype(np.uint8)
                              ).tobytes()
            assert got == ref, (s, c)


def test_make_receiver_mesh_factorisation_policy():
    """Published policy: 'sub' and 'time' each take one factor of 2 when
    available, the rest is 'ens' (the north-star data-parallel axis);
    odd/prime counts are pure 'ens'."""
    from dab_radio_tpu.parallel.mesh import make_receiver_mesh
    expect = {1: (1, 1, 1), 2: (1, 1, 2), 3: (3, 1, 1), 4: (1, 2, 2),
              5: (5, 1, 1), 6: (3, 1, 2), 7: (7, 1, 1), 8: (2, 2, 2)}
    for n, (ens, time, sub) in expect.items():
        m = make_receiver_mesh(n)
        assert (m.shape["ens"], m.shape["time"], m.shape["sub"]) == \
            (ens, time, sub), (n, dict(m.shape))


def test_distributed_single_host_path():
    """jax.distributed helpers: single-host no-op init, global mesh over
    all (virtual) devices, and host-local IQ assembly feeding the sharded
    demod without data movement."""
    from dab_radio_tpu.parallel import distributed as D
    from dab_radio_tpu.parallel.mesh import make_timesharded_demod
    from dab_radio_tpu.models.demodulator import OFDMDemodulator, DemodCarry
    from dab_radio_tpu.ops.iq import iq_pairs
    import jax

    assert D.initialize() is False          # single host: no-op
    mesh = D.global_receiver_mesh()
    assert int(np.prod(list(mesh.shape.values()))) == len(jax.devices())

    demod = OFDMDemodulator(2)
    fs = demod.params.nb_frame_samples
    n_time = mesh.shape["time"]
    B = mesh.shape["ens"] * 2
    rng = np.random.default_rng(0)
    iq = iq_pairs(
        (rng.normal(0, .5, (B, n_time * fs))
         + 1j * rng.normal(0, .5, (B, n_time * fs))).astype(np.complex64))
    garr = D.host_local_iq_to_global(mesh, iq, P("ens", "time"))
    assert garr.shape == iq.shape
    step = make_timesharded_demod(demod, mesh, frames_per_shard=1)
    carry = jax.device_put(DemodCarry.init((B, n_time)),
                           jax.sharding.NamedSharding(
                               mesh, P("ens", "time")))
    carry, bits, _ = step(carry, garr)
    assert bits.shape[:2] == (B, n_time)


def test_block_tracking_demod_matches_sequential_on_clean_signal():
    """The serving fast path (block-batched demod, per-block sync updates)
    must produce the same bits as the sequential per-frame scan on a
    locked clean signal."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dab_radio_tpu.parallel.mesh import (make_receiver_mesh,
                                             multichip_receiver_step)
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.ops.iq import iq_pairs

    mode = 2
    mesh = make_receiver_mesh(1, axis_sizes=(1, 1, 1))
    F, S = 8, 2
    cfg = [SubchannelConfig(s * 12, 12, False, eep_type="A",
                            eep_prot_level=2) for s in range(S)]
    tx = EnsembleTransmitter(
        mode, ensemble_id=0xC0BB, ensemble_label="BT",
        services=[ServiceSpec(0xF100 + s, s, f"S{s}", cfg[s])
                  for s in range(S)])
    iq = np.concatenate(
        [tx.modulate_frame_bits(np.asarray(tx.next_frame_bits()))
         for _ in range(F)])[None]

    outs = {}
    for bt in (False, True):
        step, (carry, hist, _) = multichip_receiver_step(
            mesh, mode, F, subchannels_per_shard=S, ensembles_per_shard=1,
            subchannel_cfgs=cfg, block_tracking=bt)
        g = jax.device_put(jnp.asarray(iq_pairs(iq)),
                           NamedSharding(mesh, P("ens", "time")))
        _, _, out = step(carry, hist, g)
        outs[bt] = (np.asarray(out["fib_bits"]), np.asarray(out["msc_bits"]))
    np.testing.assert_array_equal(outs[False][0], outs[True][0])
    np.testing.assert_array_equal(outs[False][1], outs[True][1])


def test_fused_fleet_on_multichip_mesh():
    """FusedFleet over a real ('ens','time','sub') mesh: the production
    serving API shards N streams' rounds across 8 virtual devices and the
    byte layer still discovers services and decodes AUs."""
    import jax
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.parallel.mesh import make_receiver_mesh

    mode = 2
    mesh = make_receiver_mesh(8)            # (2, 2, 2)
    S, N, K = 2, 2, 4
    cfgs = [SubchannelConfig(s * 12, 12, False, eep_type="A",
                             eep_prot_level=2) for s in range(S)]
    tx = EnsembleTransmitter(
        mode, ensemble_id=0xC0FF, ensemble_label="MeshServe",
        services=[ServiceSpec(0xF200 + s, s, f"Mesh {s}", cfgs[s])
                  for s in range(S)])
    tx.enable_tone_audio(base_freq=440.0)
    fleet = FusedFleet(N, cfgs, transmission_mode=mode, frames_per_step=K,
                       mesh=mesh)
    hits = []
    fleet.on_access_unit.append(lambda b, s, i, n, au, h: hits.append((b, s)))
    frames = []
    for _ in range(24):
        bits = np.asarray(tx.next_frame_bits())
        frames.append(tx.modulate_frame_bits(bits))
    iq = np.concatenate(frames)
    iq = iq / np.abs(iq).max() * 0.5     # simulate_transmitter's u8 scale
    u8 = np.clip(np.round(
        np.stack([iq.real, iq.imag], -1).reshape(-1) * 127.5 + 127.5),
        0, 255).astype(np.uint8)
    chunk = 2 * fleet.round_samples
    for r in range(u8.shape[0] // chunk):
        blk = np.tile(u8[r * chunk:(r + 1) * chunk][None], (N, 1))
        fleet.process_round(blk)
    summ = fleet.summary()
    assert summ["access_units"] > 0
    assert {b for b, _ in hits} == set(range(N))
    assert fleet.receivers[0].db.ensemble.label == "MeshServe"


@pytest.mark.slow
def test_northstar_shape_program_au_parity():
    """Many-ensemble program shape: one fused serving program sharded
    {ens: 8} must compile, decode, and produce AU byte streams identical
    to the unsharded host path on every stream; this pins the harness +
    parity semantics at a CI-sized 16 streams x 2/shard."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_northstar.py")
    spec = importlib.util.spec_from_file_location("bench_northstar", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--streams", "16", "--rounds", "3"]) == 0


def test_multichip_per_stream_layouts_bit_exact():
    """Each stream monitors a DIFFERENT ensemble layout (per-stream cfg
    rows) and the single padded program decodes all of them bit-exactly —
    the N-distinct-ensembles serving scenario."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dab_radio_tpu.parallel.mesh import (make_receiver_mesh,
                                             multichip_receiver_step)
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.params import SubchannelConfig, get_dab_params
    from dab_radio_tpu.dab.msc import MSCDecoder
    from dab_radio_tpu.ops.iq import iq_pairs

    mode = 2
    dab = get_dab_params(mode)
    mesh = make_receiver_mesh(4, axis_sizes=(2, 1, 2))
    F = 20
    grid = [
        [SubchannelConfig(0, 12, False, eep_type="A", eep_prot_level=2),
         SubchannelConfig(12, 16, True, uep_table_index=0)],
        [SubchannelConfig(0, 21, False, eep_type="B", eep_prot_level=1),
         SubchannelConfig(30, 12, False, eep_type="A", eep_prot_level=0)],
    ]
    step, (carry, hist, _) = multichip_receiver_step(
        mesh, mode, F, subchannels_per_shard=1, ensembles_per_shard=1,
        subchannel_cfgs=grid)
    assert step.per_stream

    frame_bits, iq = [], []
    for b, row in enumerate(grid):
        tx = EnsembleTransmitter(
            mode, ensemble_id=0xC100 + b, ensemble_label=f"PerStream {b}",
            services=[ServiceSpec(0xF300 + 16 * b + s, s, f"S{b}.{s}", c)
                      for s, c in enumerate(row)])
        fb, fi = [], []
        for _ in range(F):
            fb.append(np.asarray(tx.next_frame_bits()))
            fi.append(tx.modulate_frame_bits(fb[-1]))
        frame_bits.append(np.stack(fb))
        iq.append(np.concatenate(fi))
    frame_bits = np.stack(frame_bits)
    iq = np.stack(iq)

    g = jax.device_put(jnp.asarray(iq_pairs(iq)),
                       NamedSharding(mesh, P("ens", "time")))
    carry, hist, out = step(carry, hist, g)
    msc_bits = np.asarray(jax.device_get(out["msc_bits"]))

    warm = 16
    for b, row in enumerate(grid):
        for s, cfg in enumerate(row):
            dec = MSCDecoder(cfg)
            cifs = frame_bits[b, :, dab.nb_fic_bits:].reshape(
                F * dab.nb_cifs, dab.nb_cif_bits)
            nb = step.msc_nb_data_bits[b][s]
            for c in range(F * dab.nb_cifs):
                ref = dec.decode_cif(cifs[c])
                if c < warm:
                    continue
                got = np.packbits(msc_bits[b, s, c][:nb].astype(np.uint8)
                                  ).tobytes()
                assert got == ref, (b, s, c)


def test_multichip_chainback_parallel_bit_exact():
    """chainback="parallel" (log-depth map-composition traceback) must
    produce identical outputs to the sequential walk through the WHOLE
    sharded program — FIC and MSC, exact and tiled viterbi modes — on the
    same input (deterministic decode: any input pins the wiring; the
    ops-level exactness proof is test_viterbi.py)."""
    mesh = make_receiver_mesh(8)

    outs = {}
    for viterbi in ("exact", "tiled"):
        for cb in ("sequential", "parallel"):
            step, (carry, hist, iq) = multichip_receiver_step(
                mesh, transmission_mode=2, viterbi=viterbi, chainback=cb)
            iq = jax.device_put(
                jnp.asarray(np.random.default_rng(5).normal(
                    0, 0.3, np.asarray(iq).shape).astype(np.float32)),
                iq.sharding)
            _, _, out = step(carry, hist, iq)
            outs[(viterbi, cb)] = {k: np.asarray(v) for k, v in out.items()}
        seq, par = outs[(viterbi, "sequential")], outs[(viterbi, "parallel")]
        for k in ("fib_bits", "msc_bits", "fic_err"):
            np.testing.assert_array_equal(par[k], seq[k], err_msg=f"{viterbi}:{k}")


def test_multichip_chainback_fused_bit_exact():
    """chainback="fused" (traceback-free register exchange: packed decoded
    bits ride the forward ACS scan) must match the sequential walk through
    the whole sharded program — FIC and MSC, exact and tiled viterbi
    modes. Survivor selection is the identical packed-min ACS, so the bits
    match exactly, ties included (ops proof: test_viterbi.py)."""
    mesh = make_receiver_mesh(8)

    for viterbi in ("exact", "tiled"):
        outs = {}
        for cb in ("sequential", "fused"):
            step, (carry, hist, iq) = multichip_receiver_step(
                mesh, transmission_mode=2, viterbi=viterbi, chainback=cb)
            iq = jax.device_put(
                jnp.asarray(np.random.default_rng(5).normal(
                    0, 0.3, np.asarray(iq).shape).astype(np.float32)),
                iq.sharding)
            _, _, out = step(carry, hist, iq)
            outs[cb] = {k: np.asarray(v) for k, v in out.items()}
        for k in ("fib_bits", "msc_bits", "fic_err"):
            np.testing.assert_array_equal(outs["fused"][k],
                                          outs["sequential"][k],
                                          err_msg=f"{viterbi}:{k}")


def test_fuse_fic_bit_exact_vs_separate_decode():
    """fuse_fic=True (FIC lanes padded into the ONE MSC Viterbi scan —
    the scan-depth lever, parallel/mesh.py docstring) must reproduce the
    separate-decode outputs exactly on a real signal: fib_bits, fic_err
    (reported on the standalone scale), per-frame offsets, and every
    subchannel's payload region of msc_bits (the common padded width
    grows to cover the 774-step FIC trellis; consumers slice by
    msc_nb_data_bits)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dab_radio_tpu.parallel.mesh import (make_receiver_mesh,
                                             multichip_receiver_step)
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.ops.iq import iq_pairs

    mode = 2
    F, S = 8, 2
    # 48-CU subchannels make the common MSC trellis LONGER than the
    # 774-step FIC trellis, so the FIC lanes are actually padded —
    # a 12-CU shape (nb_steps == 774, zero pad) masked a round-4 bug
    # where fic_err re-subtracted the pad offset it never carried
    cfg = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                            eep_prot_level=2) for s in range(S)]
    tx = EnsembleTransmitter(
        mode, ensemble_id=0xC0CC, ensemble_label="FF",
        services=[ServiceSpec(0xF200 + s, s, f"S{s}", cfg[s])
                  for s in range(S)])
    iq = np.concatenate(
        [tx.modulate_frame_bits(np.asarray(tx.next_frame_bits()))
         for _ in range(F)])[None]

    for n, ax in ((1, (1, 1, 1)), (8, None)):
        mesh = make_receiver_mesh(n, axis_sizes=ax)
        B = mesh.shape["ens"]
        outs, nbd = {}, {}
        for ff in (False, True):
            step, (carry, hist, _) = multichip_receiver_step(
                mesh, mode, F // mesh.shape["time"],
                subchannels_per_shard=S // mesh.shape["sub"],
                ensembles_per_shard=1, subchannel_cfgs=cfg, fuse_fic=ff)
            giq = np.broadcast_to(
                iq_pairs(iq), (B, iq.shape[1], 2)).copy()
            g = jax.device_put(jnp.asarray(giq),
                               NamedSharding(mesh, P("ens", "time")))
            _, _, out = step(carry, hist, g)
            outs[ff] = {k: np.asarray(v) for k, v in out.items()}
            nbd[ff] = step.msc_nb_data_bits
        assert nbd[True] == nbd[False]
        for k in ("fib_bits", "fic_err", "offsets"):
            np.testing.assert_array_equal(outs[True][k], outs[False][k],
                                          err_msg=f"n={n}:{k}")
        for s, nb in enumerate(nbd[True]):
            np.testing.assert_array_equal(
                outs[True]["msc_bits"][:, s, :, :nb],
                outs[False]["msc_bits"][:, s, :, :nb],
                err_msg=f"n={n}:msc{s}")
