"""Full-system closed loop: synthetic DAB ensemble (FIC + DAB+ services) ->
OFDM IQ -> streaming demodulator -> receiver -> database + decoded access
units. This is the validation the reference can only do with recorded RF
captures (SURVEY.md §4); the framework's own transmitter closes the loop.
"""

import numpy as np
import pytest

from dab_radio_tpu.params import SubchannelConfig
from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
from dab_radio_tpu.models.demodulator import OFDMDemodulator, StreamingDemodulator
from dab_radio_tpu.models.receiver import DabReceiver
from dab_radio_tpu.dab.aac import SuperFrameHeader


def _make_tx():
    svc = ServiceSpec(
        service_id=0xF123, subchannel_id=3, label="Radio DAB",
        cfg=SubchannelConfig(start_address=0, length=48, is_uep=False,
                             eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(48000, True, True, False, 0))
    return EnsembleTransmitter(1, services=[svc]), svc


# deterministic AU payload generator so RX can verify content
def _au_maker(seed0):
    state = {"i": 0}

    def make(cap, num):
        rng = np.random.default_rng(seed0 + state["i"])
        state["i"] += 1
        base = cap // num
        sizes = [base] * (num - 1) + [cap - base * (num - 1)]
        return [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                for n in sizes]
    return make


@pytest.fixture(scope="module")
def decoded_system():
    tx, svc = _make_tx()
    tx.set_au_source(3, _au_maker(1000))
    # enough frames: 16-CIF deinterleaver delay (4 frames mode I) + 5-frame
    # superframes; 16 frames -> 64 CIFs -> ~48 decoded -> ~9 superframes
    nb_frames = 16
    iq = tx.generate(nb_frames)

    demod = OFDMDemodulator(1)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(1)
    received = {"aus": [], "headers": [], "channels": []}
    rx.on_audio_channel.append(
        lambda sub_id, ch: received["channels"].append((sub_id, ch.kind)))

    def on_channel(sub_id, ch):
        ch.events.on_access_unit.append(
            lambda i, n, au, hdr: received["aus"].append(au))
        ch.events.on_superframe_header.append(
            lambda hdr: received["headers"].append(hdr))
    rx.on_audio_channel.append(on_channel)

    lead = np.zeros(10000, np.complex64)
    frames = sd.process(np.concatenate([lead, iq,
                                        np.zeros(200000, np.complex64)]))
    for fr in frames:
        rx.process_frame(fr)
    return tx, svc, rx, received, len(frames)


def test_ofdm_lock(decoded_system):
    _, _, _, _, nb_frames = decoded_system
    assert nb_frames >= 15


def test_database_contents(decoded_system):
    tx, svc, rx, _, _ = decoded_system
    db = rx.db
    assert db.ensemble.id == 0xC0FE
    assert db.ensemble.label == "DAB Ensemble"
    assert svc.service_id in db.services
    assert db.services[svc.service_id].label == "Radio DAB"
    sch = db.subchannels[svc.subchannel_id]
    assert sch.is_complete and sch.length == 48 and not sch.is_uep


def test_channel_created_and_superframes_decode(decoded_system):
    _, svc, rx, received, _ = decoded_system
    assert (svc.subchannel_id, "dab+") in received["channels"]
    assert len(received["headers"]) == 1
    hdr = received["headers"][0]
    assert hdr.sampling_rate == 48000 and hdr.sbr and hdr.is_stereo
    assert len(received["aus"]) >= 6


def test_au_content_matches_transmitter(decoded_system):
    """Decoded AUs must bit-match what the AU source generated."""
    _, _, _, received, _ = decoded_system
    expected = []
    make = _au_maker(1000)
    for k in range(6):
        expected += make(1311, 3)  # capacity for 48CU EEP-3A: computed below
    # recompute capacity from the actual encoder to avoid hardcoding
    from dab_radio_tpu.dab.msc import MSCEncoder
    from dab_radio_tpu.dab.aac import SuperframeEncoder
    enc = MSCEncoder(SubchannelConfig(0, 48, False, eep_type="A",
                                      eep_prot_level=2))
    sf = SuperframeEncoder(enc.nb_data_bytes,
                           SuperFrameHeader(48000, True, True, False, 0))
    cap = sf.au_capacity()
    expected = []
    make = _au_maker(1000)
    for k in range(4):
        expected += make(cap, 3)
    got = received["aus"]
    assert len(got) >= 6
    # first decoded superframe may not be superframe 0 (deinterleaver ramp
    # drops the first 15 CIFs) — find alignment then require exact match
    first = got[0]
    start = expected.index(first) if first in expected else -1
    assert start >= 0, "decoded AU not found in transmitted sequence"
    for i, au in enumerate(got[: len(expected) - start]):
        assert au == expected[start + i]


def _ensemble_end_to_end(mode, nb_frames):
    from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
    from dab_radio_tpu.models.demodulator import OFDMDemodulator, StreamingDemodulator
    from dab_radio_tpu.models.receiver import DabReceiver
    from dab_radio_tpu.params import SubchannelConfig

    tx = EnsembleTransmitter(mode, services=[
        ServiceSpec(0xB001, 1, f"Mode{mode} Svc",
                    SubchannelConfig(0, 48, False, eep_type="A",
                                     eep_prot_level=2))])
    iq = tx.generate(nb_frames)

    demod = OFDMDemodulator(mode)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(mode)
    aus = []
    rx.on_audio_channel.append(
        lambda _id, ch: ch.events.on_access_unit.append(
            lambda i, n, au, hdr: aus.append(bytes(au))))
    for bits in sd.process(np.concatenate(
            [iq, np.zeros(2 * demod.params.nb_frame_samples, np.complex64)])):
        rx.process_frame(bits)

    assert rx.db.services
    assert list(rx.db.services.values())[0].label == f"Mode{mode} Svc"
    assert len(rx.channels) == 1
    assert len(aus) > 0


def test_mode4_ensemble_end_to_end():
    """Mode IV: 48 ms frames, 2 CIFs/frame, 6 FIBs/frame."""
    _ensemble_end_to_end(4, 40)


def test_mode2_ensemble_end_to_end():
    """Full RF chain in transmission mode II (24 ms frames, 1 CIF/frame):
    synthesized ensemble -> demod -> FIC -> channel -> access units."""
    from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
    from dab_radio_tpu.models.demodulator import OFDMDemodulator, StreamingDemodulator
    from dab_radio_tpu.models.receiver import DabReceiver
    from dab_radio_tpu.params import SubchannelConfig

    tx = EnsembleTransmitter(2, services=[
        ServiceSpec(0xB001, 1, "Mode2 Svc",
                    SubchannelConfig(0, 48, False, eep_type="A",
                                     eep_prot_level=2))])
    iq = tx.generate(60)   # mode II frames are 24 ms: need ~50 for audio

    demod = OFDMDemodulator(2)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(2)
    aus = []
    rx.on_audio_channel.append(
        lambda _id, ch: ch.events.on_access_unit.append(
            lambda i, n, au, hdr: aus.append(bytes(au))))
    for bits in sd.process(np.concatenate(
            [iq, np.zeros(2 * demod.params.nb_frame_samples, np.complex64)])):
        rx.process_frame(bits)

    assert rx.db.services and list(rx.db.services.values())[0].label == "Mode2 Svc"
    assert len(rx.channels) == 1
    assert len(aus) > 0
