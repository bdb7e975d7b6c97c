"""Real audio through the whole stack: transmitter tone AUs (valid AAC-LC@960
with crafted SBR payloads / real MP2 frames) -> frame soft bits -> receiver ->
codec layer -> non-silent PCM with the tone at the expected frequency.

Without it no test
decoded real compressed audio to PCM (the reference's core deliverable,
src/basic_radio/basic_dab_plus_channel.cpp:81-113 / mp2_audio_decoder.cpp).
The OFDM layer is bypassed (covered by test_end_to_end) so this stays fast.
"""

import numpy as np
import pytest

from dab_radio_tpu.params import SubchannelConfig
from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                              ServiceSpec, MP2ToneSource)
from dab_radio_tpu.models.receiver import DabReceiver
from dab_radio_tpu.dab.aac import SuperFrameHeader
from dab_radio_tpu.host.native import codecs_lib


def _run_chain(svc, nb_frames=24, tone=523.25):
    tx = EnsembleTransmitter(1, services=[svc])
    tx.enable_tone_audio(base_freq=tone)
    rx = DabReceiver(1)
    pcm_chunks = []
    meta = {}

    def on_channel(sub_id, ch):
        if hasattr(ch, "enable_audio_decode"):
            ch.enable_audio_decode()
        ch.events.on_audio_data.append(
            lambda pcm, rate, nch: (pcm_chunks.append(pcm),
                                    meta.update(rate=rate, nch=nch)))
    rx.on_audio_channel.append(on_channel)
    for _ in range(nb_frames):
        rx.process_frame(np.asarray(tx.next_frame_bits()))
    return pcm_chunks, meta


def _tone_freq(pcm, rate, nch):
    x = pcm.reshape(-1, nch)[:, 0].astype(np.float64)
    x = x[len(x) // 3:]
    F = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.fft.rfftfreq(len(x), 1.0 / rate)[F.argmax()]


def test_dab_plus_sbr_stereo_tone_to_pcm():
    """48 kHz SBR stereo (the dominant real-world DAB+ config)."""
    svc = ServiceSpec(
        service_id=0xF123, subchannel_id=3, label="Radio DAB",
        cfg=SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(48000, True, True, False, 0))
    pcm_chunks, meta = _run_chain(svc)
    assert pcm_chunks, "no PCM decoded"
    assert meta["rate"] == 48000 and meta["nch"] == 2
    pcm = np.concatenate(pcm_chunks)
    rms = pcm.astype(np.float64).std()
    assert rms > 500, f"silent PCM (rms={rms})"
    f = _tone_freq(pcm, meta["rate"], meta["nch"])
    assert abs(f - 523.25) < 30, f"tone at {f} Hz"


def test_dab_plus_lc_mono_tone_to_pcm():
    """32 kHz non-SBR mono variant."""
    svc = ServiceSpec(
        service_id=0xF124, subchannel_id=4, label="Radio Mono",
        cfg=SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(32000, False, False, False, 0))
    pcm_chunks, meta = _run_chain(svc, tone=440.0)
    assert pcm_chunks, "no PCM decoded"
    assert meta["rate"] == 32000 and meta["nch"] == 1
    pcm = np.concatenate(pcm_chunks)
    assert pcm.astype(np.float64).std() > 500
    f = _tone_freq(pcm, meta["rate"], meta["nch"])
    assert abs(f - 440.0) < 30, f"tone at {f} Hz"


def test_dab_mp2_tone_to_pcm():
    """Classic DAB: real MP2 frames decode to a non-silent stereo tone."""
    lib = codecs_lib()
    if lib is None or not MP2ToneSource(384).is_available:
        pytest.skip("MP2 encoder unavailable")
    svc = ServiceSpec(
        service_id=0xF125, subchannel_id=5, label="Radio MP2",
        cfg=SubchannelConfig(0, 84, False, eep_type="A", eep_prot_level=2),
        kind="dab")
    pcm_chunks, meta = _run_chain(svc, nb_frames=12, tone=660.0)
    assert pcm_chunks, "no PCM decoded"
    assert meta["rate"] == 48000 and meta["nch"] == 2
    pcm = np.concatenate(pcm_chunks)
    assert pcm.astype(np.float64).std() > 500
    f = _tone_freq(pcm, meta["rate"], meta["nch"])
    assert abs(f - 660.0) < 30, f"tone at {f} Hz"


def test_sbr_high_band_energy_present():
    """The SBR stage must actually add high-band content above the core's
    Nyquist (24 kHz core -> energy above ~12 kHz only via SBR)."""
    svc = ServiceSpec(
        service_id=0xF123, subchannel_id=3, label="Radio DAB",
        cfg=SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(48000, True, True, False, 0))
    pcm_chunks, meta = _run_chain(svc)
    pcm = np.concatenate(pcm_chunks).reshape(-1, 2)[:, 0].astype(np.float64)
    pcm = pcm[len(pcm) // 3:]
    F = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm)))) ** 2
    fr = np.fft.rfftfreq(len(pcm), 1 / 48000)
    hi = F[(fr > 5000) & (fr < 10000)].sum()
    assert hi > 0
    # the crafted envelope places audible energy in the SBR band
    tone = F[(fr > 400) & (fr < 700)].sum()
    assert hi > 1e-6 * tone


def test_dab_plus_he_aac_v2_ps_tone_to_true_stereo():
    """HE-AAC v2 (SBR + parametric stereo): mono core + IID pan must decode
    to TRUE stereo (not duplicated mono) via dab/ps_synth.py. The
    transmitter writes a left-leaning IID pan (iid index 4 ~ +10 dB L/R)."""
    svc = ServiceSpec(
        service_id=0xF125, subchannel_id=5, label="Radio DAB PS",
        cfg=SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(48000, False, True, True, 0))
    pcm_chunks, meta = _run_chain(svc, nb_frames=30)
    assert pcm_chunks, "no PCM decoded"
    assert meta["nch"] == 2
    pcm = np.concatenate(pcm_chunks).reshape(-1, 2).astype(np.float64)
    pcm = pcm[len(pcm) // 2:]
    l_rms = pcm[:, 0].std()
    r_rms = pcm[:, 1].std()
    assert l_rms > 100, "left channel silent"
    # true stereo: the IID pan makes L distinctly louder than R, and the
    # channels are not byte-identical duplicates
    assert l_rms > 1.5 * r_rms, (l_rms, r_rms)
    diff = np.abs(pcm[:, 0] - pcm[:, 1]).max()
    assert diff > 100, "channels are duplicated mono"


def test_ps_stream_snapshot_resume_continues_stereo():
    """Snapshot a receiver mid-PS-stream, restore, re-enable audio: the
    restored receiver must resume decoding TRUE stereo (codec handles and
    PS synthesis state are rebuilt; decode state carries over)."""
    svc = ServiceSpec(
        service_id=0xF126, subchannel_id=6, label="PS Resume",
        cfg=SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(48000, False, True, True, 0))
    tx = EnsembleTransmitter(1, services=[svc])
    tx.enable_tone_audio(base_freq=523.25)
    rx = DabReceiver(1)
    pcm_chunks = []
    meta = {}

    def on_channel(sub_id, ch):
        if hasattr(ch, "enable_audio_decode"):
            ch.enable_audio_decode()
        ch.events.on_audio_data.append(
            lambda pcm, rate, nch: (pcm_chunks.append(pcm),
                                    meta.update(nch=nch)))
    rx.on_audio_channel.append(on_channel)
    for _ in range(14):
        rx.process_frame(np.asarray(tx.next_frame_bits()))
    assert pcm_chunks, "no PCM before snapshot"

    blob = rx.snapshot()
    rx2 = DabReceiver.from_snapshot(blob)
    pcm_chunks.clear()
    rx2.on_audio_channel.append(on_channel)
    for sub_id, ch in rx2.channels.items():    # re-attach sinks + audio
        on_channel(sub_id, ch)
    for _ in range(16):
        rx2.process_frame(np.asarray(tx.next_frame_bits()))
    assert pcm_chunks, "no PCM after resume"
    assert meta["nch"] == 2
    pcm = np.concatenate(pcm_chunks).reshape(-1, 2).astype(np.float64)
    pcm = pcm[len(pcm) // 2:]
    assert pcm[:, 0].std() > 100
    assert pcm[:, 0].std() > 1.5 * pcm[:, 1].std()   # IID pan survived


def test_dab_plus_sbr_32k_tone_to_pcm():
    """32 kHz HE-AAC (16 kHz core + SBR): exercises the low-rate frequency
    tables (k0/k2 offsets differ from 48 kHz) end to end."""
    svc = ServiceSpec(
        service_id=0xF127, subchannel_id=7, label="Radio 32k",
        cfg=SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(32000, False, True, False, 0))
    pcm_chunks, meta = _run_chain(svc, nb_frames=26, tone=440.0)
    assert pcm_chunks, "no PCM decoded"
    assert meta["rate"] == 32000
    pcm = np.concatenate(pcm_chunks)
    freq = _tone_freq(pcm, meta["rate"], meta["nch"])
    assert abs(freq - 440.0) < 30, freq
