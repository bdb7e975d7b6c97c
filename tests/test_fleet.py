"""Fleet orchestration: cross-ensemble batched decode must be bit-identical
to standalone per-ensemble receivers."""

import os

import numpy as np
import pytest

from dab_radio_tpu.params import SubchannelConfig
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.models.receiver import DabReceiver
from dab_radio_tpu.models.fleet import ReceiverFleet

NB_FRAMES = 22


def _make_ensembles():
    """Three ensembles; EEP-3A appears in two of them so the fleet forms a
    cross-receiver decode group, plus a distinct EEP-1A shape."""
    specs = [
        [ServiceSpec(0xA101, 1, "Ens0 Svc A",
                     SubchannelConfig(0, 48, False, eep_type="A",
                                      eep_prot_level=2)),
         ServiceSpec(0xA102, 2, "Ens0 Svc B",
                     SubchannelConfig(48, 48, False, eep_type="A",
                                      eep_prot_level=2))],
        [ServiceSpec(0xB201, 1, "Ens1 Svc A",
                     SubchannelConfig(0, 48, False, eep_type="A",
                                      eep_prot_level=2))],
        [ServiceSpec(0xC301, 1, "Ens2 Svc A",
                     SubchannelConfig(0, 48, False, eep_type="A",
                                      eep_prot_level=0))],
    ]
    txs = [EnsembleTransmitter(1, ensemble_id=0xE000 + k, services=s)
           for k, s in enumerate(specs)]
    frames = [[tx.next_frame_bits() for _ in range(NB_FRAMES)] for tx in txs]
    return frames


def _attach(rx, sink):
    def on_channel(sub_id, ch):
        sink.setdefault(sub_id, [])
        ch.events.on_access_unit.append(
            lambda i, n, au, hdr, _s=sink[sub_id]: _s.append(bytes(au)))
    rx.on_audio_channel.append(on_channel)


@pytest.fixture(scope="module")
def ensembles():
    return _make_ensembles()


def _api_iq() -> np.ndarray:
    """Shared 19-frame 2-service ensemble capture for the FusedFleet tests
    (generated on first use so every test is order-independent)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "_capture.py")
    spec = importlib.util.spec_from_file_location("_capture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_capture(2, 19)


def test_fleet_matches_standalone(ensembles):
    frames = ensembles

    # standalone receivers
    ref_aus = []
    ref_rx = []
    for k in range(3):
        rx = DabReceiver(1)
        sink = {}
        _attach(rx, sink)
        for f in frames[k]:
            rx.process_frame(f)
        ref_aus.append(sink)
        ref_rx.append(rx)

    # fleet
    fleet = ReceiverFleet(3)
    fleet_aus = [dict() for _ in range(3)]
    for k in range(3):
        _attach(fleet.receivers[k], fleet_aus[k])
    for t in range(NB_FRAMES):
        fleet.process_frames([(k, frames[k][t]) for k in range(3)])

    for k in range(3):
        # database parity
        ref_db, fl_db = ref_rx[k].db, fleet.receivers[k].db
        assert {s.label for s in ref_db.services.values()} \
            == {s.label for s in fl_db.services.values()}
        assert set(ref_rx[k].channels) == set(fleet.receivers[k].channels)
        # decoded access units byte-identical
        assert ref_aus[k].keys() == fleet_aus[k].keys()
        for sub in ref_aus[k]:
            assert len(ref_aus[k][sub]) > 0
            assert ref_aus[k][sub] == fleet_aus[k][sub], (k, sub)

    s = fleet.summary()
    assert s["receivers"] == 3
    assert s["ensembles_discovered"] == 3
    assert s["channels"] == 4


def test_fleet_partial_rounds(ensembles):
    """Receivers can miss rounds (stream not yet locked) without corrupting
    the others' decode state."""
    frames = ensembles
    fleet = ReceiverFleet(2)
    sinks = [dict(), dict()]
    for k in range(2):
        _attach(fleet.receivers[k], sinks[k])
    # receiver 1 joins 4 rounds late
    for t in range(NB_FRAMES):
        batch = [(0, frames[0][t])]
        if t >= 4:
            batch.append((1, frames[1][t - 4]))
        fleet.process_frames(batch)
    assert sinks[0] and sinks[1]
    for sub, aus in sinks[0].items():
        assert len(aus) > 0


def test_fleet_pipelined_decode(ensembles):
    """pipeline_depth>0 defers host fetches; the decoded AU stream for each
    channel must be a contiguous run of the synchronous fleet's stream
    (channel discovery lags `depth` frames, so it may start later)."""
    frames = ensembles

    def run(depth):
        fleet = ReceiverFleet(3, pipeline_depth=depth)
        sinks = [dict() for _ in range(3)]
        for k in range(3):
            _attach(fleet.receivers[k], sinks[k])
        for t in range(NB_FRAMES):
            fleet.process_frames([(k, frames[k][t]) for k in range(3)])
        fleet.flush()
        return sinks

    ref = run(0)
    pipe = run(2)
    for k in range(3):
        assert ref[k].keys() == pipe[k].keys()
        for sub in ref[k]:
            a, b = ref[k][sub], pipe[k][sub]
            assert len(b) > 0
            # b must appear as a contiguous run inside a
            joined_a = b"\x00sep\x00".join(a)
            joined_b = b"\x00sep\x00".join(b)
            assert joined_b in joined_a, (k, sub, len(a), len(b))


def test_receiver_snapshot_resume(ensembles):
    """A receiver restored from a snapshot continues the decode exactly:
    same AU stream, same database, across the superframe/deinterleaver
    carry boundary."""
    from dab_radio_tpu.models.receiver import DabReceiver
    frames = ensembles[0]
    split = 13   # mid-stream: deinterleaver full, superframes in flight

    rx = DabReceiver(1)
    sink_a = {}
    _attach(rx, sink_a)
    for f in frames[:split]:
        rx.process_frame(f)
    blob = rx.snapshot()

    # continue the original
    for f in frames[split:]:
        rx.process_frame(f)

    # restore + re-attach sinks, then continue identically
    rx2 = DabReceiver.from_snapshot(blob)
    sink_b = {}
    # channels already exist in the snapshot: hook them directly
    for sub_id, ch in rx2.channels.items():
        sink_b.setdefault(sub_id, [])
        ch.events.on_access_unit.append(
            lambda i, n, au, hdr, _s=sink_b[sub_id]: _s.append(bytes(au)))
    _attach(rx2, sink_b)   # and any channels created later
    for f in frames[split:]:
        rx2.process_frame(f)

    assert {s.label for s in rx.db.services.values()} \
        == {s.label for s in rx2.db.services.values()}
    # AUs decoded after the split must match exactly
    for sub in sink_b:
        n_after = len(sink_b[sub])
        assert n_after > 0
        assert sink_a[sub][-n_after:] == sink_b[sub]


def test_fleet_snapshot_resume(ensembles):
    from dab_radio_tpu.models.fleet import ReceiverFleet
    frames = ensembles
    fleet = ReceiverFleet(3, pipeline_depth=2)
    for t in range(12):
        fleet.process_frames([(k, frames[k][t]) for k in range(3)])
    blob = fleet.snapshot()

    fleet2 = ReceiverFleet.from_snapshot(blob)
    sinks = [dict() for _ in range(3)]
    for k in range(3):
        for sub_id, ch in fleet2.receivers[k].channels.items():
            sinks[k].setdefault(sub_id, [])
            ch.events.on_access_unit.append(
                lambda i, n, au, hdr, _s=sinks[k][sub_id]: _s.append(bytes(au)))
    for t in range(12, NB_FRAMES):
        fleet2.process_frames([(k, frames[k][t]) for k in range(3)])
    fleet2.flush()
    assert fleet2.summary()["receivers"] == 3
    assert any(aus for s in sinks for aus in s.values())


def test_fused_fleet_serving_api(ensembles):
    """FusedFleet: the static-config serving path decodes N streams with
    one jitted round program; FIBs populate the databases and superframe
    AUs fire callbacks (heterogeneous shapes covered by test_parallel)."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()

    N, K, S = 3, 4, 2
    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(S)]
    fleet = FusedFleet(N, cfgs, transmission_mode=1, frames_per_step=K)
    hits = []
    fleet.on_access_unit.append(
        lambda b, s, i, n, au, hdr: hits.append((b, s)))
    chunk = 2 * fleet.round_samples
    for r_ in range(iq.shape[0] // chunk):
        blk = np.tile(iq[r_ * chunk:(r_ + 1) * chunk][None], (N, 1))
        fleet.process_round(blk, defer_fetch=True)
    fleet.flush()
    summ = fleet.summary()
    assert summ["access_units"] > 0 and hits
    assert {b for b, _ in hits} == set(range(N))
    assert {s for _, s in hits} == set(range(S))
    assert summ["services"] == N * 2
    assert fleet.receivers[0].db.ensemble.label == "DAB Ensemble"


def test_fused_fleet_audio_to_pcm(ensembles):
    """FusedFleet IQ -> PCM: enable_audio routes superframe AUs through the
    codec layer; the tone comes out non-silent."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()

    N, K, S = 2, 4, 2
    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(S)]
    fleet = FusedFleet(N, cfgs, transmission_mode=1, frames_per_step=K)
    fleet.enable_audio(0, 0)
    pcm_chunks = []
    fleet.on_audio_data.append(
        lambda b, s, pcm, rate, nch: pcm_chunks.append((b, s, pcm)))
    chunk = 2 * fleet.round_samples
    for r in range(iq.shape[0] // chunk):
        blk = np.tile(iq[r * chunk:(r + 1) * chunk][None], (N, 1))
        fleet.process_round(blk)
    assert pcm_chunks
    assert {(b, s) for b, s, _ in pcm_chunks} == {(0, 0)}
    pcm = np.concatenate([p for _, _, p in pcm_chunks]).astype(np.float64)
    assert np.sqrt((pcm[len(pcm) // 2:] ** 2).mean()) > 100


def test_discovery_to_fused_handoff():
    """The deployment flow: dynamic DabReceiver discovers the subchannel
    layout via FIC, FusedFleet.from_receiver builds the static fused
    program from it and continues decoding (database carried over)."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet

    iq = _api_iq()

    # phase 1: dynamic discovery over the first frames
    from dab_radio_tpu.host.native import iq_convert
    from dab_radio_tpu.models.demodulator import (OFDMDemodulator,
                                                  StreamingDemodulator)
    demod = OFDMDemodulator(1)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(1)
    nb = 0
    for bits in sd.process(iq_convert(
            iq[:2 * 6 * demod.params.nb_frame_samples + 2 * demod.window_len]
            .tobytes(), "u8")):
        rx.process_frame(bits)
        nb += 1
    assert len(rx.db.subchannels) == 2, rx.db.subchannels

    # phase 2: fused serving from the discovered layout
    fleet = FusedFleet.from_receiver(rx, nb_streams=2,
                                     transmission_mode=1, frames_per_step=4)
    assert fleet.receivers[0].db.ensemble.label == "DAB Ensemble"
    hits = []
    fleet.on_access_unit.append(lambda b, s, i, n, au, h: hits.append((b, s)))
    chunk = 2 * fleet.round_samples
    for r in range(iq.shape[0] // chunk):
        blk = np.tile(iq[r * chunk:(r + 1) * chunk][None], (2, 1))
        fleet.process_round(blk)
    assert fleet.summary()["access_units"] > 0
    assert {s for _, s in hits} == {0, 1}


def test_fused_fleet_cold_start_alignment():
    """find_alignment locates the frame boundary in a misaligned raw u8
    stream; fused rounds decode from the returned offset."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()
    junk = np.full(2 * 77777, 127, np.uint8)       # misalign by 77777 samples
    stream = np.concatenate([junk, iq])

    cfgs = [SubchannelConfig(s * 48, 48, False, eep_type="A",
                             eep_prot_level=2) for s in range(2)]
    fleet = FusedFleet(1, cfgs, transmission_mode=1, frames_per_step=4)
    off = fleet.find_alignment(stream[:2 * 3 * 196608])
    assert off is not None and off % 2 == 0
    # the junk is null-like (constant 127): alignment may land at the junk/
    # signal boundary or the first in-signal frame; either way decode works
    aligned = stream[off:]
    chunk = 2 * fleet.round_samples
    for r in range(min(aligned.shape[0] // chunk, 8)):
        fleet.process_round(aligned[r * chunk:(r + 1) * chunk][None])
    assert fleet.summary()["access_units"] > 0


def test_fused_fleet_per_stream_ensembles():
    """Two streams monitor DIFFERENT ensembles (different subchannel
    layouts) through one fused program; each stream's database and AUs
    come out right."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    grid = [
        [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)],
        [SubchannelConfig(24, 36, False, eep_type="B", eep_prot_level=2)],
    ]
    txs = []
    for b, row in enumerate(grid):
        tx = EnsembleTransmitter(
            1, ensemble_id=0xD000 + b, ensemble_label=f"Own {b}",
            services=[ServiceSpec(0xF400 + b, 0, f"Svc {b}", row[0])])
        tx.enable_tone_audio(base_freq=440.0 * (b + 1))
        txs.append(tx)

    fleet = FusedFleet(2, grid, transmission_mode=1, frames_per_step=4)
    hits = []
    fleet.on_access_unit.append(lambda b, s, i, n, au, h: hits.append(b))
    for _ in range(5):
        rows = []
        for tx in txs:
            frames = [tx.modulate_frame_bits(np.asarray(tx.next_frame_bits()))
                      for _ in range(fleet.frames_per_round)]
            iq = np.concatenate(frames)
            iq = iq / np.abs(iq).max() * 0.5
            rows.append(np.clip(np.round(
                np.stack([iq.real, iq.imag], -1).reshape(-1) * 127.5
                + 127.5), 0, 255).astype(np.uint8))
        fleet.process_round(np.stack(rows))
    assert fleet.summary()["access_units"] > 0
    assert set(hits) == {0, 1}
    assert fleet.receivers[0].db.ensemble.label == "Own 0"
    assert fleet.receivers[1].db.ensemble.label == "Own 1"
    assert fleet.receivers[1].db.subchannels[0].eep_type == "B"


def test_fused_fleet_reset_reproduces_fresh_decode():
    """reset() restarts device carry + host byte layer while keeping the
    compiled program: replaying the capture after reset must reproduce the
    fresh fleet's decode exactly (the bench --both link-bound pass relies
    on this for frame alignment and per-pass AU verification)."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()
    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(48, 48, False, eep_type="A", eep_prot_level=2)]
    fleet = FusedFleet(2, cfgs, transmission_mode=1, frames_per_step=4)
    chunk = 2 * fleet.round_samples

    def run():
        aus = []
        cb = lambda b, s, i, n, au, h: aus.append((b, s, bytes(au)))
        fleet.on_access_unit.append(cb)
        for r in range(iq.shape[0] // chunk):
            fleet.process_round(
                np.tile(iq[r * chunk:(r + 1) * chunk][None], (2, 1)))
        fleet.on_access_unit.remove(cb)
        return aus, fleet.total_aus

    first, n1 = run()
    fleet.reset()
    again, n2 = run()
    assert n1 > 0 and n2 == n1
    assert again == first
    assert fleet.receivers[0].db.ensemble.label == "DAB Ensemble"


def test_fleet_scraper_serving_disk_tree(tmp_path):
    """FleetScraper: the serving-path disk sink — per-(stream,sub)
    AAC(ADTS) bitstreams and WAV audio for enable_audio'd channels under
    stream_<b>/subchannel_<s>/ (reference basic_scraper tree, fused
    edition)."""
    from dab_radio_tpu.host.scraper import FleetScraper
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()
    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(48, 48, False, eep_type="A", eep_prot_level=2)]
    fleet = FusedFleet(2, cfgs, transmission_mode=1, frames_per_step=4)
    fleet.enable_audio(0, 0)
    scraper = FleetScraper(str(tmp_path))
    scraper.attach(fleet)
    chunk = 2 * fleet.round_samples
    for r in range(iq.shape[0] // chunk):
        fleet.process_round(
            np.tile(iq[r * chunk:(r + 1) * chunk][None], (2, 1)))
    scraper.close()

    for b in (0, 1):
        for s in (0, 1):
            p = tmp_path / f"stream_{b}" / f"subchannel_{s}" / "stream.aac"
            assert p.exists() and p.stat().st_size > 1000, p
    wavs = list((tmp_path / "stream_0" / "subchannel_0").glob("*.wav"))
    assert wavs and wavs[0].stat().st_size > 44
    # packet-mode subchannels get their MOT hook at attach time
    pf = FusedFleet(1, cfgs[:1], transmission_mode=1, frames_per_step=4,
                    subchannel_kinds=[("packet", 2, 0)])
    FleetScraper(str(tmp_path / "pkt")).attach(pf)
    assert pf._sfp[0][0].mot.on_entity


def test_channel_snapshot_restores_internal_mot_wiring():
    """MOTProcessor.__getstate__ drops ALL on_entity hooks (external
    observers can hold closures/file handles); a restored channel must
    re-wire its OWN slideshow hook — and only it — via _rewire."""
    import pickle
    from dab_radio_tpu.models.receiver import DabChannel, DabPlusChannel
    from dab_radio_tpu.params import SubchannelConfig

    cfg = SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)
    for cls in (DabPlusChannel, DabChannel):
        ch = cls(cfg)
        pad = ch.aac_data.pad if cls is DabPlusChannel else ch.pad_extractor.pad
        pad.on_mot_entity.append(lambda e: None)   # external (unpicklable)
        ch2 = pickle.loads(pickle.dumps(ch))
        pad2 = (ch2.aac_data.pad if cls is DabPlusChannel
                else ch2.pad_extractor.pad)
        assert pad2.on_mot_entity == [ch2.slideshows.process_mot_entity]


def test_fused_fleet_tiled_viterbi_matches_exact():
    """viterbi='tiled' (overlap-save MSC decode, ~4.8x lower sequential
    scan depth) decodes the clean capture to the SAME AU stream as the
    exact full-trellis decode — the tiled accuracy contract at/above
    operating SNR (ops/viterbi.py:viterbi_decode_soft_tiled)."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()
    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(48, 48, False, eep_type="A", eep_prot_level=2)]

    def run(mode):
        fleet = FusedFleet(1, cfgs, transmission_mode=1, frames_per_step=4,
                           viterbi=mode)
        aus = []
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, h: aus.append((s, bytes(au))))
        chunk = 2 * fleet.round_samples
        for r in range(iq.shape[0] // chunk):
            fleet.process_round(iq[r * chunk:(r + 1) * chunk][None])
        return aus

    exact = run("exact")
    tiled = run("tiled")
    assert exact and tiled == exact


def test_fused_fleet_radix8_matches_exact():
    """viterbi='radix8' (3 trellis steps per scan iteration, exact incl.
    ties) decodes the same AU stream as radix-4 exact through the whole
    serving path — including the 6+24k common-trellis padding both now
    share (the iteration-count lever for serving lane counts)."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()
    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(48, 48, False, eep_type="A", eep_prot_level=2)]

    def run(mode):
        fleet = FusedFleet(1, cfgs, transmission_mode=1, frames_per_step=4,
                           viterbi=mode)
        aus = []
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, h: aus.append((s, bytes(au))))
        chunk = 2 * fleet.round_samples
        for r in range(iq.shape[0] // chunk):
            fleet.process_round(iq[r * chunk:(r + 1) * chunk][None])
        return aus

    exact = run("exact")
    radix8 = run("radix8")
    assert exact and radix8 == exact


def test_fused_fleet_lut_branch_matches_matmul():
    """viterbi_branch='lut' (16-entry branch-metric factorization) is
    bit-identical to the matmul route through the WHOLE serving path —
    the kernel-level pin (test_radix4_matches_radix2_exactly) extended
    to the fused program's padded/fused-FIC lanes and the byte layer."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()
    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(48, 48, False, eep_type="A", eep_prot_level=2)]

    def run(branch):
        fleet = FusedFleet(1, cfgs, transmission_mode=1, frames_per_step=4,
                           viterbi_branch=branch)
        aus = []
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, h: aus.append((s, bytes(au))))
        chunk = 2 * fleet.round_samples
        for r in range(iq.shape[0] // chunk):
            fleet.process_round(iq[r * chunk:(r + 1) * chunk][None])
        return aus

    matmul = run("matmul")
    lut = run("lut")
    assert matmul and lut == matmul


def test_fused_fleet_snapshot_resume():
    """Serving-path checkpoint/resume: snapshot() mid-stream, rebuild via
    from_snapshot() (new program compile, databases + device carry +
    byte-layer sync carried over), and the combined AU stream is
    byte-identical to an uninterrupted run — parity with the dynamic
    receiver/fleet snapshots (SURVEY §5.4)."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    iq = _api_iq()
    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
            SubchannelConfig(48, 48, False, eep_type="A", eep_prot_level=2)]
    def mk():
        return FusedFleet(2, cfgs, transmission_mode=1, frames_per_step=4)

    def feed(fleet, rounds, aus):
        cb = lambda b, s, i, n, au, h: aus.append((b, s, bytes(au)))
        fleet.on_access_unit.append(cb)
        chunk = 2 * fleet.round_samples
        for r in rounds:
            fleet.process_round(
                np.tile(iq[r * chunk:(r + 1) * chunk][None], (2, 1)))
        fleet.on_access_unit.remove(cb)

    nrounds = iq.shape[0] // (2 * mk().round_samples)
    ref_aus = []
    feed(mk(), range(nrounds), ref_aus)

    half = nrounds // 2
    fleet = mk()
    got = []
    feed(fleet, range(half), got)
    blob = fleet.snapshot()
    # original object unusable after? No — snapshot is non-destructive:
    feed(fleet, range(half, half + 1), got[:0])  # still runs
    resumed = FusedFleet.from_snapshot(blob)
    assert resumed.total_rounds == half
    feed(resumed, range(half, nrounds), got)
    assert ref_aus and got == ref_aus
    assert resumed.receivers[0].db.ensemble.label == "DAB Ensemble"
    assert resumed.summary()["services"] == 4


def test_fused_fleet_snapshot_mesh_retarget_gate():
    """A snapshot taken on a time-sharded mesh cannot silently restore on
    a mesh with a different 'time' factor (the carry's leading dims embed
    it): from_snapshot raises a clear ValueError instead of a shape
    mismatch deep inside the jitted demod. Same-shape retargets restore
    with the target program's shardings."""
    import pytest as _pytest
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.parallel.mesh import make_receiver_mesh
    from dab_radio_tpu.params import SubchannelConfig

    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)]
    mesh2 = make_receiver_mesh(2, axis_sizes=(1, 2, 1))
    fleet = FusedFleet(1, cfgs, transmission_mode=1, frames_per_step=2,
                       mesh=mesh2)
    blob = fleet.snapshot()
    with _pytest.raises(ValueError, match="time"):
        FusedFleet.from_snapshot(blob)            # default 1-device mesh
    resumed = FusedFleet.from_snapshot(blob, mesh=mesh2)
    assert resumed.frames_per_round == fleet.frames_per_round


def test_fused_fleet_snapshot_packet_dg_flow_after_restore():
    """Data groups keep flowing to fleet.on_data_group after a
    snapshot/restore cycle: the restored packet processor's byte state is
    carried and _stream_job's collector re-routes its output (observer
    closures themselves are stripped for pickling)."""
    from dab_radio_tpu.dab.packets import PacketStreamEncoder
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.params import SubchannelConfig

    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)]
    fleet = FusedFleet(1, cfgs, transmission_mode=1, frames_per_step=4,
                       subchannel_kinds=[("packet", 2, 0)])
    blob = fleet.snapshot()
    resumed = FusedFleet.from_snapshot(blob)
    hits = []
    resumed.on_data_group.append(
        lambda b, s, res: hits.append((b, s, bytes(res.data))))

    # drive the restored byte layer directly with a valid packet stream
    enc = PacketStreamEncoder(2)
    enc.push_data_group(b"\x00" * 2 + b"hello-dg")
    nb = resumed._nbytes[0][0]
    payload = enc.emit(-(-len(enc._bytes) // 24) * 24)
    C = -(-len(payload) // nb)
    msc = np.zeros((1, 1, C, nb), np.uint8)
    flat = np.frombuffer(payload.ljust(C * nb, b"\x00"), np.uint8)
    msc[0, 0] = flat.reshape(C, nb)
    fibs = np.zeros((1, 1, 3, 32), np.uint8)     # no valid FIBs this round
    resumed._fire(0, resumed._stream_job(
        0, fibs, np.zeros((1, 1, 3), bool), msc))
    assert hits and hits[0][:2] == (0, 0)
    assert resumed.total_data_groups == len(hits) > 0


def test_fused_fleet_mixed_kinds_audio_mp2_packet():
    """The fused byte layer routes every reference channel kind: DAB+
    superframes -> AUs, classic DAB -> MP2 frames, packet mode -> MOT
    data groups — all decoded by ONE jitted round program (the dynamic
    path's channel taxonomy, receiver.py:_update_channels, in serving
    form)."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.models.pad_writer import (build_mot_header,
                                                 build_mot_segment)
    from dab_radio_tpu.dab.mot import HEADER, UNSCRAMBLED_BODY
    from dab_radio_tpu.dab.mp2 import parse_mp2_header

    services = [
        ServiceSpec(0xA001, 1, "AAC Service",
                    SubchannelConfig(0, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="dab+"),
        ServiceSpec(0xA002, 2, "MP2 Service",
                    SubchannelConfig(48, 84, True, uep_table_index=33),
                    kind="dab"),
        ServiceSpec(0xA003, 3, "Data Service",
                    SubchannelConfig(132, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="packet",
                    scid=0x10, packet_address=2),
    ]
    tx = EnsembleTransmitter(1, services=services)
    tx.enable_tone_audio()     # real AAC + MP2 tone audio on the air
    rng = np.random.default_rng(7)
    body = rng.integers(0, 256, 300).astype(np.uint8).tobytes()
    segs = [body[i:i + 128] for i in range(0, len(body), 128)]
    for _ in range(14):
        tx.push_packet_data_group(
            3, build_mot_segment(HEADER, 0, True, 0x42,
                                 build_mot_header(body, "file.bin")))
        for i, s in enumerate(segs):
            tx.push_packet_data_group(
                3, build_mot_segment(UNSCRAMBLED_BODY, i,
                                     i == len(segs) - 1, 0x42, s))
    from dab_radio_tpu.host.native import iq_quantize_u8

    def frame_u8():
        f = tx.next_frame_iq()
        return iq_quantize_u8(f * (0.5 / max(np.abs(f).max(), 1e-9)))
    iq = np.frombuffer(b"".join(frame_u8() for _ in range(24)), np.uint8)

    cfgs = [s.cfg for s in services]
    kinds = ["audio", "mp2", ("packet", 2, 0)]
    fleet = FusedFleet(1, cfgs, transmission_mode=1, frames_per_step=4,
                       subchannel_kinds=kinds)
    got = {"aus": 0, "mp2": [], "dg": 0, "pcm": []}
    fleet.on_access_unit.append(lambda *a: got.__setitem__(
        "aus", got["aus"] + 1))
    fleet.on_mp2_frame.append(lambda b, s, fr: got["mp2"].append(fr))
    fleet.enable_audio(0, 1)               # MP2 -> PCM through the codec
    fleet.on_audio_data.append(
        lambda b, s, pcm, rate, nch: got["pcm"].append((s, pcm, rate)))
    mot = []
    fleet._sfp[0][2].mot.on_entity.append(mot.append)
    fleet.on_data_group.append(lambda *a: got.__setitem__(
        "dg", got["dg"] + 1))
    chunk = 2 * fleet.round_samples
    for r in range(iq.shape[0] // chunk):
        fleet.process_round(iq[r * chunk:(r + 1) * chunk][None])

    assert got["aus"] > 0
    assert got["dg"] > 0
    assert len(got["mp2"]) >= 10
    # the first 16 frames carry deinterleaver warm-up garbage (16-CIF
    # depth = 16 logical frames; the fused path decodes from round 1
    # while the dynamic path's channels spawn post-FIC): the settled
    # tail must be valid 384-byte 48 kHz MP2 frames
    parsed = [parse_mp2_header(f) for f in got["mp2"][16:]]
    assert parsed and all(h is not None and h.sample_rate == 48000
                          for h in parsed)
    assert all(len(f) == 384 for f in got["mp2"][16:])
    assert mot and mot[0].body == body \
        and mot[0].header.content_name == "file.bin"
    # MP2 tone -> non-silent PCM through the fused audio path
    settled = [p for s_, p, r in got["pcm"][8:] if s_ == 1]
    if settled:                 # (empty only if the codec shim is absent)
        pcm = np.concatenate(settled).astype(np.float64)
        assert np.sqrt((pcm ** 2).mean()) > 100
    s = fleet.summary()
    assert s["data_groups"] == got["dg"] and s["mp2_frames"] >= 10


@pytest.mark.slow
def test_serving_soak_constant_memory():
    """tools/soak.py: ~45 s of looped fused serving holds RSS flat and
    keeps decoding AUs (the long-running serving contract)."""
    import json as json_mod
    import subprocess
    import sys as sys_mod
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys_mod.executable, os.path.join(root, "tools", "soak.py"),
         "--seconds", "45", "--sample-s", "10", "--streams", "2",
         "--frames-per-step", "4", "--backend", "cpu"],
        capture_output=True, timeout=400, cwd=root)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    res = json_mod.loads(r.stdout.decode().strip().splitlines()[-1])
    assert res["ok"] and res["total_aus"] > 0
    assert res["rss_growth"] < 0.15


@pytest.mark.parametrize("levers", [
    dict(),
    dict(viterbi="tiled", chainback="parallel", consume_workers=2),
    dict(viterbi="tiled", chainback="fused", block_tracking=True),
], ids=["default", "all-levers", "min-depth"])
def test_fused_fleet_mode_2_serving(levers):
    """The fused serving path across a different transmission mode: a
    mode-II ensemble (24 ms frames, 1 CIF/frame, 384-pt FFT geometry)
    decodes through FusedFleet with AUs firing and the database equal to
    the host DabReceiver's on the same capture. The all-levers variant
    stacks tiled Viterbi + parallel chainback + sharded consume to pin
    lever interactions."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.models.demodulator import (OFDMDemodulator,
                                                  StreamingDemodulator)

    svc = ServiceSpec(0xD201, 1, "Mode2 Svc",
                      SubchannelConfig(0, 48, False, eep_type="A",
                                       eep_prot_level=2))
    tx = EnsembleTransmitter(2, ensemble_id=0xD0D0, services=[svc])
    tx.enable_tone_audio()
    nb_frames = 64
    iq_c = tx.generate(nb_frames)
    # peak-normalize before u8 quantization (simulate_transmitter's
    # contract; raw modulator amplitude is ~17 and would clip to garbage)
    iq_c = (iq_c / np.abs(iq_c).max() * 0.5).astype(np.complex64)
    from dab_radio_tpu.host.native import iq_quantize_u8
    u8 = np.frombuffer(iq_quantize_u8(iq_c), dtype=np.uint8)

    N, K = 2, 8
    fleet = FusedFleet(N, [svc.cfg], transmission_mode=2, frames_per_step=K,
                       **levers)
    hits = []
    fleet.on_access_unit.append(
        lambda b, s, i, n, au, hdr: hits.append((b, bytes(au))))
    chunk = 2 * fleet.round_samples
    tb = fleet.tail_bytes
    for r_ in range(u8.shape[0] // chunk):
        lo = r_ * chunk
        blk = np.tile(u8[lo:lo + chunk][None], (N, 1))
        t = u8[lo + chunk:lo + chunk + tb]
        tail = np.tile(t[None], (N, 1)) if t.shape[0] == tb else None
        fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
    fleet.flush()
    assert fleet.total_aus > 0 and hits
    assert fleet.receivers[0].db.ensemble.id == 0xD0D0
    assert fleet.receivers[0].db.services[0xD201].label == "Mode2 Svc"

    # host-path reference on the same capture: identical AU stream
    rx = DabReceiver(2, benchmark_all=True)
    ref_aus = []
    rx.on_audio_channel.append(
        lambda sub, ch: ch.events.on_access_unit.append(
            lambda i, n, au, hdr: ref_aus.append(bytes(au))))
    sd = StreamingDemodulator(OFDMDemodulator(2))
    for bits in sd.process(iq_c):
        rx.process_frame(bits)
    got = [a for b, a in hits if b == 0]
    assert ref_aus, "host path decoded no AUs - raise nb_frames"
    m = min(len(got), len(ref_aus))
    assert m >= len(ref_aus) - 6
    assert got[:m] == ref_aus[:m]


def test_consume_workers_equals_serial():
    """consume_workers>1 shards the byte layer across threads but must
    reproduce the serial path's observer event stream byte-for-byte and
    in order — the full taxonomy (DAB+ AUs, MP2 frames with PCM decode,
    packet-mode data groups) on the same capture."""
    from dab_radio_tpu.models.fused_fleet import FusedFleet
    from dab_radio_tpu.models.pad_writer import (build_mot_header,
                                                 build_mot_segment)
    from dab_radio_tpu.dab.mot import HEADER, UNSCRAMBLED_BODY
    from dab_radio_tpu.host.native import iq_quantize_u8

    services = [
        ServiceSpec(0xA001, 1, "AAC Service",
                    SubchannelConfig(0, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="dab+"),
        ServiceSpec(0xA002, 2, "MP2 Service",
                    SubchannelConfig(48, 84, True, uep_table_index=33),
                    kind="dab"),
        ServiceSpec(0xA003, 3, "Data Service",
                    SubchannelConfig(132, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="packet",
                    scid=0x10, packet_address=2),
    ]

    def capture():
        tx = EnsembleTransmitter(1, services=services)
        tx.enable_tone_audio()
        rng = np.random.default_rng(7)
        body = rng.integers(0, 256, 300).astype(np.uint8).tobytes()
        segs = [body[i:i + 128] for i in range(0, len(body), 128)]
        for _ in range(10):
            tx.push_packet_data_group(
                3, build_mot_segment(HEADER, 0, True, 0x42,
                                     build_mot_header(body, "f.bin")))
            for i, sg in enumerate(segs):
                tx.push_packet_data_group(
                    3, build_mot_segment(UNSCRAMBLED_BODY, i,
                                         i == len(segs) - 1, 0x42, sg))

        def frame_u8():
            f = tx.next_frame_iq()
            return iq_quantize_u8(f * (0.5 / max(np.abs(f).max(), 1e-9)))
        return np.frombuffer(b"".join(frame_u8() for _ in range(24)),
                             np.uint8)

    iq = capture()
    cfgs = [s.cfg for s in services]
    kinds = ["audio", "mp2", ("packet", 2, 0)]

    def run(workers):
        N = 3
        fleet = FusedFleet(N, cfgs, transmission_mode=1, frames_per_step=4,
                           subchannel_kinds=kinds,
                           consume_workers=workers)
        fleet.enable_audio(0, 1)
        events = []
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, hdr: events.append(
                ("au", b, s, i, n, bytes(au))))
        fleet.on_mp2_frame.append(
            lambda b, s, fr: events.append(("mp2", b, s, bytes(fr))))
        fleet.on_data_group.append(
            lambda b, s, res: events.append(
                ("dg", b, s, bytes(res.data))))
        fleet.on_audio_data.append(
            lambda b, s, pcm, rate, nch: events.append(
                ("pcm", b, s, np.asarray(pcm).tobytes(), rate, nch)))
        chunk = 2 * fleet.round_samples
        for r in range(iq.shape[0] // chunk):
            blk = np.tile(iq[r * chunk:(r + 1) * chunk][None], (N, 1))
            fleet.process_round(blk, defer_fetch=True)
        fleet.flush()
        return events, (fleet.total_aus, fleet.total_mp2_frames,
                        fleet.total_data_groups)

    ev_serial, counts_serial = run(0)
    ev_par, counts_par = run(4)
    assert counts_serial == counts_par
    assert counts_serial[0] > 0 and counts_serial[2] > 0
    assert ev_par == ev_serial
