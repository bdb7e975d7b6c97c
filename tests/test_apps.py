"""App-level smoke tests: CLI byte contracts and the scraper disk tree."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# app subprocesses run CPU-only in tests: they must never hold a card.
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def _run(args, stdin=None, timeout=300):
    return subprocess.run([sys.executable, "-m", args[0], *args[1:]],
                          input=stdin, capture_output=True, env=ENV,
                          cwd=REPO, timeout=timeout)


def test_convert_viterbi_roundtrip():
    rng = np.random.default_rng(0)
    soft = rng.integers(-127, 128, size=4096).astype(np.int8).tobytes()
    r1 = _run(["dab_radio_tpu.apps.convert_viterbi"], stdin=soft)
    assert r1.returncode == 0 and len(r1.stdout) == 512
    r2 = _run(["dab_radio_tpu.apps.convert_viterbi", "-d"], stdin=r1.stdout)
    assert r2.returncode == 0
    back = np.frombuffer(r2.stdout, dtype=np.int8)
    orig = np.frombuffer(soft, dtype=np.int8)
    np.testing.assert_array_equal(back > 0, orig > 0)


def test_apply_frequency_shift_contract():
    raw = bytes(range(256)) * 4
    r = _run(["dab_radio_tpu.apps.apply_frequency_shift", "-f", "1000"],
             stdin=raw)
    assert r.returncode == 0 and len(r.stdout) == len(raw)


def test_rtl_sdr_list_channels():
    """Works without tuner hardware: prints the DAB block frequency table."""
    r = _run(["dab_radio_tpu.apps.rtl_sdr", "--list-channels"])
    assert r.returncode == 0
    out = r.stdout.decode()
    assert "5C" in out and "9C" in out and "MHz" in out
    # reference block_frequencies.h: channel 9C = 206.352 MHz
    line = next(l for l in out.splitlines() if l.startswith("9C"))
    assert "206.352" in line


def test_rtl_sdr_no_device_errors_cleanly():
    r = _run(["dab_radio_tpu.apps.rtl_sdr", "-c", "9C"])
    assert r.returncode == 1
    assert b"error" in r.stderr.lower()


def test_rtl_sdr_unknown_channel():
    r = _run(["dab_radio_tpu.apps.rtl_sdr", "-c", "ZZ"])
    assert r.returncode == 1
    assert b"unknown channel" in r.stderr


def test_rtl_sdr_list_devices_without_hardware():
    """Device enumeration (reference device_list.cpp) degrades to an empty
    list — not an error — on hosts with no librtlsdr/tuner."""
    from dab_radio_tpu.host.device import list_devices
    assert list_devices() == []
    r = _run(["dab_radio_tpu.apps.rtl_sdr", "--list-devices"])
    assert r.returncode == 0 and r.stdout == b""


def test_loop_file(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"abcdef")
    r = _run(["dab_radio_tpu.apps.loop_file", "-i", str(p), "-n", "3"])
    assert r.stdout == b"abcdef" * 3


def test_serve_pod_state_aggregation():
    """aggregate_pod reads the counters from state.json's "totals" (its
    top-level "streams" is the per-stream ROW LIST, which a regression
    once summed as an int, crashing the pod loop); workers that have not
    served a state yet must be tolerated."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tools"))
    try:
        from serve_pod import aggregate_pod
    finally:
        sys.path.pop(0)
    w = {"streams": [{"stream": 0}, {"stream": 1}],
         "totals": {"streams": 2, "rounds": 3, "frames": 24,
                    "access_units": 72, "services": 4}}
    pod = aggregate_pod([w, w, None])
    assert pod == {"rounds": 6, "access_units": 144, "streams": 4}
    assert aggregate_pod([]) == {"rounds": 0, "access_units": 0,
                                 "streams": 0}


@pytest.mark.slow
def test_tx_rx_pipeline(tmp_path):
    """simulate_transmitter --payload ensemble | radio_cli finds the service."""
    tx = _run(["dab_radio_tpu.apps.simulate_transmitter",
               "--payload", "ensemble", "-n", "8", "-F", "u8"])
    assert tx.returncode == 0
    iq_path = tmp_path / "ensemble.u8.iq"
    iq_path.write_bytes(tx.stdout + b"\x80" * 400000)

    scrape_dir = tmp_path / "scrape"
    rx = _run(["dab_radio_tpu.apps.radio_cli", "-i", str(iq_path),
               "-F", "u8", "--scraper-enable",
               "--scraper-output", str(scrape_dir), "--benchmark"])
    err = rx.stderr.decode()
    assert rx.returncode == 0, err
    assert "DAB Ensemble" in err
    assert "Radio DAB" in err
    assert "subchannel 3" in err
    # scraper wrote the channel dir in the reference's naming
    # (service_<sid:X>_component_<cid:X>, basic_scraper.cpp:63)
    assert (scrape_dir / "service_F123_component_0").is_dir(), \
        list(scrape_dir.iterdir())


@pytest.mark.slow
def test_radio_app_and_monitor(tmp_path):
    tx = _run(["dab_radio_tpu.apps.simulate_transmitter",
               "--payload", "ensemble", "-n", "14", "-F", "u8"])
    iq_path = tmp_path / "e.iq"
    iq_path.write_bytes(tx.stdout + b"\x80" * 400000)

    wav = tmp_path / "out.wav"
    r = _run(["dab_radio_tpu.apps.radio_app", "--device", "file",
              "-i", str(iq_path), "--seconds", "30",
              "--audio-out", str(wav)], timeout=400)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    assert "DAB Ensemble" in r.stderr.decode()
    assert wav.exists() and wav.stat().st_size > 44
    # the transmitter broadcasts a real tone: the WAV must carry actual
    # decoded audio, not silence
    import wave as wave_mod
    with wave_mod.open(str(wav), "rb") as wf:
        data = np.frombuffer(wf.readframes(wf.getnframes()), np.int16)
    assert data.size > 0
    rms = float(np.sqrt(np.mean(data.astype(np.float64) ** 2)))
    assert rms > 100, f"WAV is silent (rms={rms:.1f})"

    png = tmp_path / "mon.png"
    r2 = _run(["dab_radio_tpu.apps.monitor", "-i", str(iq_path),
               "-o", str(png), "--frames", "2"], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    assert png.exists() and png.stat().st_size > 10000


@pytest.mark.slow
def test_split_pipeline_ofdm_then_dab(tmp_path):
    """'ofdm' config soft bits piped into 'dab' config (reference topology)."""
    tx = _run(["dab_radio_tpu.apps.simulate_transmitter",
               "--payload", "ensemble", "-n", "6", "-F", "u8"])
    iq_path = tmp_path / "e.iq"
    iq_path.write_bytes(tx.stdout + b"\x80" * 400000)

    r1 = _run(["dab_radio_tpu.apps.radio_cli", "-i", str(iq_path),
               "--configuration", "ofdm"], timeout=400)
    assert r1.returncode == 0
    nb_frame_bits = 230400
    assert len(r1.stdout) >= 5 * nb_frame_bits

    r2 = _run(["dab_radio_tpu.apps.radio_cli", "--configuration", "dab"],
              stdin=r1.stdout, timeout=400)
    err = r2.stderr.decode()
    assert r2.returncode == 0, err
    assert "DAB Ensemble" in err and "Radio DAB" in err


@pytest.mark.slow
def test_tui_plain_dashboard(tmp_path):
    """TUI dashboard (GUI analog) decodes a capture and renders services,
    channel stats, and the constellation in --plain mode."""
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "14", "-F", "u8"],
             timeout=400)
    assert r.returncode == 0
    iq_path.write_bytes(r.stdout)
    r2 = _run(["dab_radio_tpu.apps.tui", "-i", str(iq_path), "-F", "u8",
               "--plain", "--max-frames", "12", "--refresh", "30"],
              timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    out = r2.stdout.decode()
    assert "state=TRACK" in out
    assert "Radio DAB 1" in out and "Radio DAB 2" in out
    assert "aus=" in out
    assert "constellation" in out
    # live sync-diagnostic sparklines (all render_ofdm_demod views)
    assert "fine-time impulse" in out
    assert "coarse-freq corr" in out
    assert "null symbol PSD" in out
    assert "data symbol PSD" in out
    assert "sampling buffer" in out


@pytest.mark.slow
def test_ber_sweep_waterfall():
    """BER sweep: no lock in deep noise, lock with clean post-Viterbi decode
    at operating SNR (the FIC portion carries real encoded FIBs)."""
    r = _run(["dab_radio_tpu.apps.ber_sweep", "--snr", "2,14",
              "--cfo", "1200", "-n", "4"], timeout=500)
    assert r.returncode == 0, r.stderr.decode()[-400:]
    lines = r.stdout.decode().strip().splitlines()
    assert lines[0].startswith("snr_db,")
    low = dict(zip(lines[0].split(","), lines[1].split(",")))
    high = dict(zip(lines[0].split(","), lines[2].split(",")))
    assert int(low["locked_frames"]) == 0
    assert int(high["locked_frames"]) >= 3
    assert float(high["raw_ber"]) < 1e-2
    assert float(high["vit_byte_err"]) == 0.0
    assert float(high["fib_crc_rate"]) == 1.0


@pytest.mark.slow
def test_bench_fleet_fused_end_to_end(tmp_path):
    """The fused single-dispatch fleet round (demod+FIC+MSC in one jitted
    program) decodes ensembles end to end on the CPU backend."""
    import json
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "bench_fleet.py"),
         "--fused", "--streams", "2", "--frames", "14", "--backend", "cpu",
         "--frames-per-step", "4"],
        capture_output=True, timeout=500, cwd=root)
    assert r.returncode == 0, r.stderr.decode()[-400:]
    res = None
    for ln in r.stdout.decode().splitlines():
        if ln.strip().startswith("{"):
            res = json.loads(ln)
    assert res is not None and res["mode"] == "fused"
    # 2 streams x 2 services per synthetic ensemble
    assert res["access_units"] > 0 and res["services"] == 4


@pytest.mark.slow
def test_capture_comparison_harness_vs_reference(tmp_path):
    """tools/compare_with_reference.py: given a capture, every FIG event
    and superframe AU must match the compiled C++ reference (the
    real-capture validation path)."""
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "16", "-F", "u8"],
             timeout=400)
    assert r.returncode == 0
    iq_path.write_bytes(r.stdout)
    r2 = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "compare_with_reference.py"),
         "-i", str(iq_path), "-F", "u8", "--max-frames", "14",
         "--backend", "cpu"],
        capture_output=True, timeout=400, env=ENV, cwd=REPO)
    err = r2.stderr.decode()
    assert r2.returncode == 0, err
    assert "OK: all FIG events and superframe AUs match" in err
    assert "0 AUs" not in err


@pytest.mark.slow
def test_profile_trace_export(tmp_path):
    """--profile-trace writes a Chrome/Perfetto trace with the pipeline's
    stage spans (the reference GUI profiler-tab analog)."""
    import json
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "-n", "8", "-F", "u8"], timeout=400)
    iq_path.write_bytes(r.stdout)
    trace = tmp_path / "trace.json"
    r2 = _run(["dab_radio_tpu.apps.radio_cli", "-i", str(iq_path),
               "-F", "u8", "--max-frames", "6",
               "--profile-trace", str(trace)], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-400:]
    evs = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert "demod/frame_step" in names and "radio/fic_decode" in names


@pytest.mark.slow
def test_webmon_serves_dashboard_and_state(tmp_path):
    """Web GUI analog: /state.json shows the decoded ensemble and
    /dashboard.png renders the live diagnostic panels."""
    import json as json_mod
    import time as time_mod
    import urllib.request
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "-n", "24", "-F", "u8", "--slideshow"],
             timeout=400)
    iq_path.write_bytes(r.stdout)
    port = 8791
    proc = subprocess.Popen(
        [sys.executable, "-m", "dab_radio_tpu.apps.webmon",
         "-i", str(iq_path), "-F", "u8", "--port", str(port),
         "--max-frames", "22"],
        env=ENV, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        state = None
        for _ in range(120):
            time_mod.sleep(1)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/state.json",
                        timeout=5) as resp:
                    state = json_mod.loads(resp.read())
                if state.get("done") and state.get("frames", 0) >= 22:
                    break
            except Exception:
                continue
        assert state is not None, proc.stderr.read().decode()[-400:] \
            if proc.poll() is not None else "server never answered"
        assert state["frames"] >= 22
        assert state["ensemble"]["id"] == "C0FE"
        assert any("Radio DAB" in s["label"] for s in state["services"])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/dashboard.png", timeout=60) as resp:
            png = resp.read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 10000
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=5) as resp:
            assert b"live monitor" in resp.read()
        # radio-browser surface: per-channel state incl. the broadcast
        # dynamic label, and the MOT slideshow image endpoint
        chans = state.get("channels", [])
        assert chans, state
        labeled = [c for c in chans if c.get("dynamic_label")]
        assert labeled and labeled[0]["dynamic_label"].startswith("Now:")
        with_ss = [c for c in chans if c.get("slideshows", 0) > 0]
        assert with_ss, chans
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/slideshow/"
                f"{with_ss[0]['subchannel']}", timeout=5) as resp:
            img = resp.read()
            assert resp.headers["Content-Type"] == "image/png"
        assert img[:8] == b"\x89PNG\r\n\x1a\n"
        # interactive controls: POST /control toggles the channel's
        # audio-control flags (the reference GUI's checkboxes) and the
        # implication rules hold (play_audio=true forces decode_audio)
        sub = chans[0]["subchannel"]
        assert "controls" in chans[0], chans[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/control",
            data=json_mod.dumps({"subchannel": sub, "flag": "play_audio",
                                 "value": True}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=5) as resp:
            new_state = json_mod.loads(resp.read())
        ctl = [c for c in new_state["channels"]
               if c["subchannel"] == sub][0]["controls"]
        assert ctl["play_audio"] and ctl["decode_audio"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/control",
            data=json_mod.dumps({"subchannel": sub,
                                 "action": "stop_all"}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=5) as resp:
            new_state = json_mod.loads(resp.read())
        ctl = [c for c in new_state["channels"]
               if c["subchannel"] == sub][0]["controls"]
        assert not (ctl["play_audio"] or ctl["decode_audio"]
                    or ctl["decode_data"])
        # hardening: a foreign-Origin POST (hostile page -> localhost
        # CSRF) is refused; a non-dict JSON body is a clean 400
        import urllib.error
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/control",
            data=b'{"subchannel": 0, "action": "run_all"}',
            headers={"Origin": "http://evil.example"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 403
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/control", data=b"5", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 400
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@pytest.mark.slow
def test_fleet_serve_cli(tmp_path):
    """fleet_serve: the multi-ensemble serving CLI — discovery mode over a
    shared capture, fused rounds, per-stream summaries, audio option."""
    import json as json_mod
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "24", "-F", "u8"],
             timeout=400)
    iq_path.write_bytes(r.stdout)
    r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(iq_path),
               "--shared-input", "--streams", "3", "--discover",
               "--frames-per-step", "4", "--audio", "0:0"], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    lines = [json_mod.loads(l) for l in r2.stdout.decode().splitlines()]
    assert len(lines) == 4                       # 3 streams + fleet total
    assert all(l["ensemble"] == "C0FE" for l in lines[:3])
    assert all("Radio DAB 1" in str(l["services"]) for l in lines[:3])
    total = lines[3]
    assert total["access_units"] > 0 and total["streams"] == 3
    assert total["pcm_samples"] > 0


@pytest.mark.slow
def test_fleet_serve_stdin_stream(tmp_path):
    """fleet_serve -i -: live-pipe serving (the reference's
    rtl_sdr | app topology). Discovery + alignment happen on the stream
    head; rounds consume stdin with constant memory; totals match the
    file-input path."""
    import json as json_mod
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "24", "-F", "u8"],
             timeout=400)
    iq = r.stdout
    r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", "-", "--streams",
               "2", "--discover", "--frames-per-step", "4",
               "--audio", "0:0"], stdin=iq, timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    lines = [json_mod.loads(l) for l in r2.stdout.decode().splitlines()]
    assert len(lines) == 3                       # 2 streams + fleet total
    assert all(l["ensemble"] == "C0FE" for l in lines[:2])
    total = lines[2]
    assert total["access_units"] > 0 and total["streams"] == 2
    assert total["pcm_samples"] > 0


@pytest.mark.slow
def test_fleet_serve_drift_reanchor(tmp_path):
    """Sample-clock drift robustness: 600 extra samples injected
    mid-capture (the accumulated drift of a real SDR's clock error) push
    the frame grid off the fused round boundaries; fleet_serve must
    detect the growing fine-time offset and re-anchor its read grid (the
    dynamic path's pointer advance), keeping the later rounds decoding
    and reporting the correction."""
    import json as json_mod
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "26", "-F", "u8"],
             timeout=400)
    iq = np.frombuffer(r.stdout, np.uint8)
    X = 8 * 196608 * 2                   # after 8 mode-I frames
    drifted = np.concatenate([iq[:X], iq[X - 1200:X], iq[X:]])
    path = tmp_path / "drift.u8"
    drifted.tofile(path)
    r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(path),
               "--subchannels", "0:48:EEP3A,48:48:EEP3A",
               "--frames-per-step", "4"], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    total = json_mod.loads(r2.stdout.decode().splitlines()[-1])
    corrected = sum(total.get("drift_corrected_samples", [0]))
    assert 500 <= corrected <= 700, total
    # decode continued past the drift event: a clean 6-round single-
    # stream run of this capture yields 96 AUs; the corrupted straddle
    # superframe may drop a few
    assert total["access_units"] >= 80, total
    assert total["services"] == 2


@pytest.mark.slow
def test_fleet_serve_under_cfo(tmp_path):
    """Serving under carrier frequency offset: a 1.7 kHz CFO (past one
    1 kHz subcarrier spacing, forcing the coarse+fine estimators) through
    apply_frequency_shift must not stop the fused serving path — the
    sharded demod tracks CFO in its carry exactly like the dynamic
    path."""
    import json as json_mod
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "24", "-F", "u8"],
             timeout=400)
    r2 = _run(["dab_radio_tpu.apps.apply_frequency_shift", "-f", "1700"],
              stdin=r.stdout, timeout=200)
    assert r2.returncode == 0
    path = tmp_path / "cfo.u8"
    path.write_bytes(r2.stdout)
    r3 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(path),
               "--subchannels", "0:48:EEP3A,48:48:EEP3A",
               "--frames-per-step", "4"], timeout=400)
    assert r3.returncode == 0, r3.stderr.decode()[-500:]
    total = json_mod.loads(r3.stdout.decode().splitlines()[-1])
    # clean capture yields 96 AUs over 6 rounds; CFO costs at most the
    # acquisition rounds
    assert total["access_units"] >= 60, total
    assert total["services"] == 2
    assert total.get("resync_events", 0) == 0, total


@pytest.mark.slow
def test_fleet_serve_desync_reacquire(tmp_path):
    """Hard desync recovery (reference §5.3 failure detection, serving
    edition): mid-stream the signal is replaced by noise and re-enters at
    an arbitrary misalignment (a retune). The serving loop must detect
    the dead FIBs, resync the device state, re-acquire the new frame
    grid and resume decoding."""
    import json as json_mod
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "40", "-F", "u8"],
             timeout=600)
    iq = np.frombuffer(r.stdout, np.uint8)
    fb = 196608 * 2                      # mode-I frame bytes
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, 2 * fb).astype(np.uint8)
    stream = np.concatenate(
        [iq[:10 * fb], noise, iq[5 * fb + 2 * 31416:]])
    path = tmp_path / "retune.u8"
    stream.tofile(path)
    r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(path),
               "--subchannels", "0:48:EEP3A,48:48:EEP3A",
               "--frames-per-step", "4"], timeout=600)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    assert b"re-acquiring" in r2.stderr
    total = json_mod.loads(r2.stdout.decode().splitlines()[-1])
    assert total.get("resync_events", 0) >= 1, total
    # decode resumed after the retune: the pre-desync phase alone yields
    # ~36 AUs (2 clean rounds post-warmup); re-acquisition adds the tail
    assert total["access_units"] >= 60, total
    assert total["services"] == 2


@pytest.mark.slow
def test_fleet_serve_status_endpoint(tmp_path):
    """fleet_serve --port: live /state.json observability while serving a
    stdin stream — per-stream ensembles/services + fleet totals update as
    rounds complete."""
    import json as json_mod
    import socket
    import time
    import urllib.error
    import urllib.request
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "24", "-F", "u8"],
             timeout=400)
    iq = r.stdout
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dab_radio_tpu.apps.fleet_serve", "-i", "-",
         "--streams", "2", "--subchannels", "0:48:EEP3A,48:48:EEP3A",
         "--frames-per-step", "4", "--port", str(port)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=ENV, cwd=REPO)
    try:
        half = len(iq) // 2
        proc.stdin.write(iq[:half])  # stream in, keep the pipe OPEN
        proc.stdin.flush()
        state = None
        for _ in range(240):        # poll until rounds land (compile lag)
            time.sleep(1)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/state.json",
                        timeout=5) as resp:
                    state = json_mod.loads(resp.read())
            except OSError:
                continue
            if state.get("totals", {}).get("rounds", 0) > 0 \
                    and state["totals"].get("services", 0) == 4:
                break
        assert state is not None and state["totals"]["rounds"] > 0, state
        assert state["totals"]["services"] == 4
        assert state["streams"][0]["ensemble"] == "C0FE"
        assert "Radio DAB 1" in str(state["streams"][1]["services"])
        assert state["streams"][0]["fib_ok"] > 0       # signal health row
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=5) as resp:
            assert b"p_con" in resp.read()   # canvas plot page

        # live OFDM plots for a running fleet_serve: the first poll arms
        # the lazy builder (503), the rounds decoding the second data
        # half build it, and subsequent polls return the payload
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/plot.json?stream=1", timeout=5)
        except urllib.error.HTTPError as e:
            assert e.code == 503
        proc.stdin.write(iq[half:])
        proc.stdin.flush()
        plot = None
        for _ in range(120):
            time.sleep(1)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/plot.json?stream=1",
                        timeout=5) as resp:
                    plot = json_mod.loads(resp.read())
                break
            except OSError:
                continue
        assert plot is not None and "error" not in plot, plot
        assert plot["stream"] == 1 and plot["rounds"] > 0
        assert len(plot["impulse_db"]) >= 128
        assert len(plot["spectrum_db"]) >= 128
        assert len(plot["constellation"]) >= 256
    finally:
        proc.stdin.close()          # EOF ends the serving loop
        proc.stdin = None           # communicate() must not re-flush it
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err.decode()[-500:]
    total = json_mod.loads(out.decode().splitlines()[-1])
    assert total["access_units"] > 0


@pytest.mark.slow
def test_fleet_serve_status_port_taken_degrades(tmp_path):
    """A taken status port must not kill the decode worker: fleet_serve
    warns, serves without the live view, and still lands its stdout
    totals (the pod orchestrator's authoritative record)."""
    import json as json_mod
    import socket
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "-n", "12", "-F", "u8"], timeout=400)
    cap = tmp_path / "cap.u8"
    cap.write_bytes(r.stdout)
    with socket.socket() as blocker:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
        r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(cap),
                   "--streams", "1", "--subchannels", "0:48:EEP3A",
                   "--frames-per-step", "4", "--max-rounds", "2",
                   "--port", str(port), "--backend", "cpu"], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    assert b"unavailable" in r2.stderr and b"serving without" in r2.stderr
    summ = json_mod.loads(r2.stdout.decode().strip().splitlines()[-1])
    assert summ["access_units"] > 0


@pytest.mark.slow
def test_fleet_serve_snapshot_resume_cli(tmp_path):
    """fleet_serve --snapshot-out / --resume: the serving checkpoint at
    the CLI surface. A run split across two processes must end with the
    same fleet totals as one uninterrupted run (radio_cli's
    checkpoint/resume contract, serving-path edition)."""
    import json as json_mod
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "24", "-F", "u8"],
             timeout=400)
    iq_path.write_bytes(r.stdout)
    layout = "0:48:EEP3A,48:48:EEP3A"
    base = ["dab_radio_tpu.apps.fleet_serve", "-i", str(iq_path),
            "--shared-input", "--streams", "2", "--subchannels", layout,
            "--frames-per-step", "4"]
    snap = tmp_path / "fleet.snap"

    full = _run(base, timeout=400)
    assert full.returncode == 0, full.stderr.decode()[-500:]
    full_total = json_mod.loads(full.stdout.decode().splitlines()[-1])

    r1 = _run(base + ["--max-rounds", "2", "--snapshot-out", str(snap)],
              timeout=400)
    assert r1.returncode == 0, r1.stderr.decode()[-500:]
    assert snap.exists()
    r2 = _run(base + ["--resume", str(snap)], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    assert b"resumed from" in r2.stderr
    resumed_total = json_mod.loads(r2.stdout.decode().splitlines()[-1])
    assert resumed_total == full_total
    assert resumed_total["access_units"] > 0
    assert resumed_total["services"] == 4


@pytest.mark.slow
def test_radio_cli_warns_on_clipped_capture(tmp_path):
    """A capture quantized without peak normalization hard-clips u8 IQ;
    radio_cli must tell the operator (FIC still decodes on such input —
    clipping preserves phase — so without the warning the 'no audio'
    failure is a mystery)."""
    import jax
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "-n", "8", "-F", "u8", "--scale", "8.0"],
             timeout=400)
    assert r.returncode == 0
    clipped = tmp_path / "clipped.u8"
    clipped.write_bytes(r.stdout)
    r2 = _run(["dab_radio_tpu.apps.radio_cli", "-i", str(clipped),
               "-F", "u8", "--max-frames", "6"], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-300:]
    err = r2.stderr.decode()
    assert "capture is clipping" in err, err[-400:]


@pytest.mark.slow
def test_serve_pod_two_workers(tmp_path):
    """tools/serve_pod.py: the process-per-chip topology — two fleet_serve
    workers over a shared capture, aggregated totals from both."""
    import json as json_mod
    import socket
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "18", "-F", "u8"],
             timeout=400)
    cap = tmp_path / "cap.u8"
    cap.write_bytes(r.stdout)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # a free base port: the default 8950 collides across concurrent suites
    # (and a taken worker port must not fail the pod — fleet_serve degrades
    # to serving without the live view; totals come from worker stdout)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        base_port = s.getsockname()[1]
    rp = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "serve_pod.py"),
         "--workers", "2", "-i", str(cap), "--streams-per-worker", "2",
         "--subchannels", "0:48:EEP3A,48:48:EEP3A",
         "--frames-per-step", "4", "--max-rounds", "3",
         "--base-port", str(base_port), "--backend", "cpu"],
        capture_output=True, timeout=500, cwd=root, env=ENV, text=True)
    assert rp.returncode == 0, rp.stderr[-800:]
    summ = json_mod.loads(rp.stdout.strip().splitlines()[-1])
    assert summ["workers_reporting"] == 2
    assert summ["streams"] == 4 and summ["access_units"] > 0


@pytest.mark.slow
def test_fleet_serve_s16_input(tmp_path):
    """fleet_serve -F: a non-u8 capture (s16) requantizes through the
    shared read path and serves end to end; a non-u8 stdin is refused
    with a clear error."""
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "18", "-F", "s16"],
             timeout=400)
    cap = tmp_path / "cap.s16"
    cap.write_bytes(r.stdout)
    r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(cap),
               "-F", "s16le", "--shared-input", "--streams", "2",
               "--discover", "--frames-per-step", "4",
               "--max-rounds", "2", "--backend", "cpu"], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-400:]
    import json as json_mod
    summ = json_mod.loads(r2.stdout.decode().strip().splitlines()[-1])
    assert summ["access_units"] > 0
    r3 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", "-",
               "-F", "s16le", "--discover", "--backend", "cpu"],
              stdin=b"", timeout=200)
    assert r3.returncode == 2
    assert b"u8 only" in r3.stderr


@pytest.mark.slow
def test_webmon_live_plots_and_tuner_retune(tmp_path):
    """Round-4 GUI parity: /plot.json streams the reference GUI's OFDM
    windows (constellation/impulse/coarse-corr/spectrum,
    render_ofdm_demod.cpp:39-336) as numeric arrays for the browser-side
    canvas renderer, and the tuner panel's POST /tune round-trips a
    channel retune through the device layer with a full decode reset."""
    import json as json_mod
    import time as time_mod
    import urllib.request
    import urllib.error
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "-n", "16", "-F", "u8"], timeout=400)
    iq_path.write_bytes(r.stdout)
    port = 8793
    proc = subprocess.Popen(
        [sys.executable, "-m", "dab_radio_tpu.apps.webmon",
         "-i", str(iq_path), "-F", "u8", "--port", str(port),
         "--device", "file", "--loop", "-c", "9C"],
        env=ENV, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{port}"

    def get(path, timeout=10):
        with urllib.request.urlopen(base + path, timeout=timeout) as resp:
            return json_mod.loads(resp.read())

    try:
        state = None
        for _ in range(120):
            time_mod.sleep(1)
            try:
                state = get("/state.json")
                if state.get("ensemble", {}).get("id") == "C0FE" \
                        and state.get("frames", 0) >= 6:
                    break
            except Exception:
                continue
        assert state and state["ensemble"]["id"] == "C0FE", \
            proc.stderr.read().decode()[-400:] if proc.poll() is not None \
            else state

        # live plot payload: all four panels present and sane
        plot = get("/plot.json", timeout=60)
        assert len(plot["impulse_db"]) >= 128
        assert len(plot["freq_response_db"]) >= 128
        assert len(plot["spectrum_db"]) >= 128
        con = plot["constellation"]
        assert len(con) >= 256 and len(con[0]) == 2
        # DQPSK on a locked frame: points cluster on the axes-rotated
        # quadrants, away from the origin
        import numpy as np
        pts = np.asarray(con, dtype=np.float64)
        assert np.isfinite(pts).all()
        assert float(np.hypot(pts[:, 0], pts[:, 1]).mean()) > 0.3

        # the embedded page carries the canvas renderer
        with urllib.request.urlopen(base + "/", timeout=5) as resp:
            page = resp.read()
        assert b"p_con" in page and b"plot.json" in page

        dev = get("/device.json")
        assert dev["device"] == "FileDevice" and dev["channel"] == "9C"
        assert dev["freq_hz"] == 206352000

        # foreign-Origin POST must be refused (CSRF gate)
        req = urllib.request.Request(
            base + "/tune", data=b'{"channel": "12B"}', method="POST",
            headers={"Origin": "http://evil.example"})
        try:
            urllib.request.urlopen(req, timeout=5)
            assert False, "foreign-origin /tune must 403"
        except urllib.error.HTTPError as e:
            assert e.code == 403

        # unknown channel -> 400
        req = urllib.request.Request(base + "/tune",
                                     data=b'{"channel": "99Z"}',
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=5)
            assert False, "unknown channel must 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400

        # the real retune: device reports the new block+frequency and the
        # decode restarts from scratch (frames reset, ensemble re-found)
        req = urllib.request.Request(base + "/tune",
                                     data=b'{"channel": "12B"}',
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            tuned = json_mod.loads(resp.read())
        assert tuned["channel"] == "12B"
        assert tuned["freq_hz"] == 225648000
        refound = None
        for _ in range(90):
            time_mod.sleep(1)
            try:
                refound = get("/state.json")
                if refound.get("ensemble", {}).get("id") == "C0FE" \
                        and refound.get("frames", 0) >= 4:
                    break
            except Exception:
                continue
        assert refound and refound["ensemble"]["id"] == "C0FE", refound
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_webmon_device_rejects_wav_format():
    """--device file replays raw sample formats only; -F wav must be
    rejected at argparse time (a round-4 review found the reader thread
    died on KeyError instead)."""
    r = _run(["dab_radio_tpu.apps.webmon", "--device", "file",
              "-i", "x.wav", "-F", "wav", "--port", "8799"])
    assert r.returncode == 2
    assert b"does not support -F wav" in r.stderr


@pytest.mark.slow
def test_webmon_device_mode_honors_max_frames(tmp_path):
    """--max-frames must terminate decode in --device mode too (the
    round-4 review found the device path dropped it: with --loop the
    file replays forever)."""
    import json as json_mod
    import time as time_mod
    import urllib.request
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "-n", "12", "-F", "u8"], timeout=400)
    iq_path.write_bytes(r.stdout)
    port = 8801
    proc = subprocess.Popen(
        [sys.executable, "-m", "dab_radio_tpu.apps.webmon",
         "-i", str(iq_path), "-F", "u8", "--port", str(port),
         "--device", "file", "--loop", "--max-frames", "6"],
        env=ENV, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        state = None
        for _ in range(120):
            time_mod.sleep(1)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/state.json",
                        timeout=5) as resp:
                    state = json_mod.loads(resp.read())
                if state.get("done"):
                    break
            except OSError:
                continue
        assert state is not None and state["done"], state
        assert state["frames"] == 6
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@pytest.mark.slow
def test_fleet_serve_prefetch_identical_output(tmp_path):
    """--prefetch (double-buffered H2D staging via host.feeder) must
    produce byte-identical serving output to synchronous feeding on a
    clean capture."""
    import json as json_mod
    iq_path = tmp_path / "iq.bin"
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "24", "-F", "u8"],
             timeout=400)
    iq_path.write_bytes(r.stdout)

    def serve(prefetch):
        r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(iq_path),
                   "--shared-input", "--streams", "2",
                   "--subchannels", "0:48:EEP3A,48:48:EEP3A",
                   "--frames-per-step", "4", "--audio", "0:0",
                   "--prefetch", str(prefetch)], timeout=400)
        assert r2.returncode == 0, r2.stderr.decode()[-500:]
        return [json_mod.loads(l) for l in r2.stdout.decode().splitlines()]

    sync, fed = serve(0), serve(2)
    assert fed == sync
    assert fed[-1]["access_units"] > 0 and fed[-1]["pcm_samples"] > 0


@pytest.mark.slow
def test_fleet_serve_prefetch_drift_reanchor(tmp_path):
    """A drift correction moves the read grid, so staged rounds were
    computed against a stale grid: --prefetch must drop and restage them
    (same corrected-sample count and AU survival as synchronous mode)."""
    import json as json_mod
    r = _run(["dab_radio_tpu.apps.simulate_transmitter", "--payload",
              "ensemble", "--services", "2", "-n", "26", "-F", "u8"],
             timeout=400)
    iq = np.frombuffer(r.stdout, np.uint8)
    X = 8 * 196608 * 2
    drifted = np.concatenate([iq[:X], iq[X - 1200:X], iq[X:]])
    path = tmp_path / "drift.u8"
    drifted.tofile(path)
    r2 = _run(["dab_radio_tpu.apps.fleet_serve", "-i", str(path),
               "--subchannels", "0:48:EEP3A,48:48:EEP3A",
               "--frames-per-step", "4", "--prefetch", "2"], timeout=400)
    assert r2.returncode == 0, r2.stderr.decode()[-500:]
    total = json_mod.loads(r2.stdout.decode().splitlines()[-1])
    corrected = sum(total.get("drift_corrected_samples", [0]))
    assert 500 <= corrected <= 700, total
    assert total["access_units"] >= 80, total
