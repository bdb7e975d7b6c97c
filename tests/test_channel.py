"""TDL multipath / SFN echo / clock-drift channel model tests.

Covers the net-new channel realism layer (models/channel.py): interpolation
kernel exactness, drift resampling, Rayleigh tap statistics, and the
closed-loop demodulator stress cases — lock + AU
continuity with an echo at the guard edge, and lock under continuous ppm
clock drift.
"""

import numpy as np
import pytest

from dab_radio_tpu.models.channel import (
    ChannelModel, EchoTap, parse_echo_spec, _interp_at, _jakes_gains,
)
from dab_radio_tpu.params.ofdm import get_ofdm_params, SAMPLE_RATE_HZ


def test_interp_at_integer_positions_exact():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    pos = np.arange(20, 200, dtype=np.float64)
    y = _interp_at(x, pos)
    np.testing.assert_allclose(y, x[20:200], rtol=0, atol=1e-6)


def test_interp_at_fractional_tone_phase():
    # delaying a tone by d samples multiplies it by exp(-j w d)
    n = 4096
    w = 2 * np.pi * 0.11                      # well inside the kernel band
    x = np.exp(1j * w * np.arange(n)).astype(np.complex64)
    d = 0.375
    pos = np.arange(64, n - 64, dtype=np.float64) - d
    y = _interp_at(x, pos)
    expect = np.exp(1j * w * (np.arange(64, n - 64) - d))
    err = np.abs(y - expect).max()
    assert err < 1e-3, err


def test_echo_tap_is_delayed_scaled_copy():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=8192) + 1j * rng.normal(size=8192)
         ).astype(np.complex64)
    fs = float(SAMPLE_RATE_HZ)
    delay_samples = 37                         # integer delay: exact copy
    tap = EchoTap(delay_us=delay_samples / fs * 1e6, gain_db=-6.0)
    y = ChannelModel(taps=[tap]).apply(x)
    a = 10 ** (-6.0 / 20)
    expect = x.copy()
    expect[delay_samples:] += (a * x[:-delay_samples]).astype(np.complex64)
    np.testing.assert_allclose(y[64:-64], expect[64:-64], atol=2e-5)


def test_drift_resampler_scales_tone_frequency():
    n = 1 << 16
    f0 = 0.05                                  # cycles/sample
    x = np.exp(2j * np.pi * f0 * np.arange(n)).astype(np.complex64)
    ppm = 200.0
    y = ChannelModel(drift_ppm=ppm).apply(x)
    # measure frequency by phase slope of y
    ph = np.unwrap(np.angle(y[256:-256]))
    f_meas = np.polyfit(np.arange(ph.size), ph, 1)[0] / (2 * np.pi)
    # complex64 phase noise + kernel ripple bound measurement at ~3e-6
    # relative; the 200 ppm shift itself is 2e-4 — 60x the floor
    assert abs(f_meas / f0 - 1 / (1 + ppm * 1e-6)) < 2e-5
    assert abs(f_meas / f0 - 1.0) > 1e-4


def test_jakes_gains_unit_power_and_coherence():
    rng = np.random.default_rng(3)
    g = _jakes_gains(1 << 18, doppler_hz=100.0, sample_rate=2.048e6, rng=rng)
    p = float(np.mean(np.abs(g) ** 2))
    assert 0.5 < p < 2.0                       # one realization, 8 sinusoids
    # coherence: adjacent samples nearly equal at fd=100 Hz / fs=2.048 MHz
    assert float(np.abs(np.diff(g[:4096])).max()) < 1e-2


def test_parse_echo_spec():
    taps = parse_echo_spec("100:-3, 240:-6:40:r,5:-1:25")
    assert taps[0] == EchoTap(100.0, -3.0)
    assert taps[1].rayleigh and taps[1].doppler_hz == 40.0
    assert taps[2] == EchoTap(5.0, -1.0, doppler_hz=25.0)
    with pytest.raises(ValueError):
        parse_echo_spec("100")


# ---- closed-loop demodulator stress --------------------------------------


def _tx_rx(channel: ChannelModel, nb_frames: int = 8, mode: int = 1):
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.models.transmitter import (
        EnsembleTransmitter, ServiceSpec)
    from dab_radio_tpu.models.demodulator import (
        OFDMDemodulator, StreamingDemodulator)
    from dab_radio_tpu.models.receiver import DabReceiver

    tx = EnsembleTransmitter(mode, services=[
        ServiceSpec(0xF123, 3, "Echo Test",
                    SubchannelConfig(0, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="dab+"),
    ])
    tx.enable_tone_audio()
    iq = tx.generate(nb_frames)
    y = channel.apply(np.concatenate(
        [np.zeros(10000, np.complex64), iq,
         np.zeros(3 * get_ofdm_params(mode).nb_frame_samples, np.complex64)]))

    sd = StreamingDemodulator(OFDMDemodulator(mode))
    rx = DabReceiver(mode)
    got = {"aus": []}
    rx.on_audio_channel.append(
        lambda sub, ch: ch.events.on_access_unit.append(
            lambda i, n, au, hdr: got["aus"].append(au)))
    frames = sd.process(y)
    for fr in frames:
        rx.process_frame(fr)
    return sd, rx, frames, got


def test_guard_edge_echo_lock_and_au_continuity():
    """SFN echo just inside the guard interval (mode I guard = 504 samples
    = 246 us): equal-power echo at 240 us must not break lock, desync, or
    the AU stream. This is the matched-filter stress the reference's
    fine-time sync faces in a single-frequency network
    (reference src/ofdm/ofdm_demodulator.cpp:473-548)."""
    ch = ChannelModel(taps=[EchoTap(delay_us=240.0, gain_db=-3.0,
                                    phase_deg=70.0)],
                      snr_db=30.0, seed=5)
    sd, rx, frames, got = _tx_rx(ch, nb_frames=12)
    # every real frame demodulated: a mid-capture desync skips frames
    # during re-acquisition, so this + the AU count is a continuity proof.
    # The channel adds receiver noise to the flush tail too, so the
    # demodulator legitimately desyncs ONCE when the signal ends.
    assert len(frames) >= 12
    assert int(sd.carry.total_desync) <= 1
    assert rx.db.ensemble.id == 0xC0FE
    assert len(got["aus"]) >= 15


def test_beyond_guard_echo_still_locks():
    """Echo past the guard (350 us > 246 us) at -8 dB: inter-symbol
    interference raises BER but the FIC must still converge."""
    ch = ChannelModel(taps=[EchoTap(delay_us=350.0, gain_db=-8.0)],
                      snr_db=30.0, seed=6)
    sd, rx, frames, got = _tx_rx(ch, nb_frames=12)
    assert len(frames) >= 12
    assert rx.db.ensemble.id == 0xC0FE
    assert len(got["aus"]) >= 10


def test_rayleigh_mobile_channel_decodes():
    """Two-tap mobile profile (direct + fading echo at 5 us, 40 Hz
    Doppler): the per-frame fine tracking must ride the fades."""
    ch = ChannelModel(
        taps=[EchoTap(delay_us=5.0, gain_db=-3.0, doppler_hz=40.0,
                      rayleigh=True)],
        snr_db=25.0, seed=7)
    sd, rx, frames, got = _tx_rx(ch, nb_frames=12)
    assert len(frames) >= 12
    assert rx.db.ensemble.id == 0xC0FE
    assert len(got["aus"]) >= 10


def test_clock_drift_lock():
    """Continuous +50 ppm sample-clock drift (a badly-trimmed SDR crystal
    drifts the frame grid ~10 samples/s in mode I): the streaming
    demodulator's per-frame timing absorption must hold lock and the AU
    stream must stay continuous over the capture."""
    ch = ChannelModel(drift_ppm=50.0, snr_db=30.0, seed=8)
    sd, rx, frames, got = _tx_rx(ch, nb_frames=12)
    assert len(frames) >= 12
    assert int(sd.carry.total_desync) <= 1
    assert rx.db.ensemble.id == 0xC0FE
    assert len(got["aus"]) >= 15
