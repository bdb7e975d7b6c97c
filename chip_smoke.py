"""Smoke test of the served path on an NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py             # one card
    python chip_smoke.py --cards 4   # only the multi-card paths, four cards

One card, in order; each phase prints one JSON line, and the first failure
ends the run with a non-zero exit code and no result line:

1. device    JAX must see a GPU (no CPU fallback); the card's name and
             power limit as nvidia-smi reports them.
2. capture   a mode-I ensemble (2 DAB+ services) synthesized by
             simulate_transmitter, and its plain reference: the CPU host
             path (radio_cli on the CPU backend) decodes it to AU bytes.
             Both run in subprocesses that never open the card. Every
             reference AU must carry the transmitter's own tone payload.
3. radio_cli the single-stream receiver on the GPU, called in-process:
             ensemble C0FE and its services, AU bytes equal to the reference.
4. fleet     FusedFleet, 16 streams x frames_per_step=16, fed u8 IQ from
             host memory with defer_fetch and the next round's head as tail:
             every (stream, subchannel) AU byte stream equals the reference.
             Prints compile seconds, round p50/p90, real-time ensembles and
             the device's peak memory.
5. kernels   the demod frame step, the radix-4 ACS + chainback and the RS
             syndromes on the GPU against the plain reference on the CPU
             backend of the same process, at real widths.

--cards 4 runs tools/serve_pod.py with one fleet_serve worker per card
(before this process initializes JAX), then a FusedFleet sharded over a
4-card mesh in the {ens:4} and the default (1,2,2) layouts, each against
the reference.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from bench import SERVICES, SUBCHANNELS  # noqa: E402

SOFT_WITHIN_1 = 0.999      # demod: share of int8 soft bits within +/-1
HARD_AGREE = 0.9999        # demod: sign agreement where the CPU bit != 0


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def note(msg: str):
    """Progress on stderr, so a run cut short shows where it was."""
    print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(msg)


def card_lines() -> list:
    """nvidia-smi's `name, power.limit` line for every card."""
    from dab_radio_tpu.utils.backend import card_info
    cards = card_info()
    check(cards, "nvidia-smi reports no card")
    return cards


def cpu_env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu")


# ---- reference ----------------------------------------------------------

def split_adts(data: bytes) -> list:
    """Raw AUs of an ADTS stream (the scraper's stream.aac)."""
    aus, i = [], 0
    while i < len(data):
        check(data[i] == 0xFF and data[i + 1] & 0xF0 == 0xF0,
              f"ADTS sync lost at byte {i}")
        flen = ((data[i + 3] & 3) << 11) | (data[i + 4] << 3) \
            | (data[i + 5] >> 5)
        hlen = 7 if data[i + 1] & 1 else 9
        aus.append(bytes(data[i + hlen:i + flen]))
        i += flen
    return aus


def scraped_aus(root: str) -> dict:
    """{channel directory: [AU bytes]} of a radio_cli scraper tree."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name, "stream.aac")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[name] = split_adts(f.read())
    return out


def au_mismatches(got: list, ref: list) -> list:
    """Human-readable differences between two AU byte lists (empty when
    they are equal)."""
    bad = []
    if len(got) != len(ref):
        bad.append(f"{len(got)} AUs vs {len(ref)} in the reference")
    for i, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            bad.append(f"AU {i} differs ({len(a)} vs {len(b)} bytes)")
            break
    return bad


def print_tone_payload():
    """(CPU subprocess) JSON {service id hex: tone AU hex} of the
    transmitter that made the capture."""
    from dab_radio_tpu.apps.simulate_transmitter import ensemble_transmitter
    tx = ensemble_transmitter(1, SERVICES)
    json.dump({f"{s.service_id:X}": tx._au_source[s.subchannel_id]._au.hex()
               for s in tx.services}, sys.stdout)


def check_tone_payload(ref: dict):
    """Every reference AU is the transmitter's tone AU of its service,
    zero-padded to its superframe slot."""
    r = subprocess.run([sys.executable, "-c",
                        "import chip_smoke; chip_smoke.print_tone_payload()"],
                       cwd=ROOT, env=cpu_env(), capture_output=True,
                       text=True, timeout=300)
    check(r.returncode == 0, f"transmitter payload: {r.stderr[-500:]}")
    tone = {k: bytes.fromhex(v) for k, v in json.loads(r.stdout).items()}
    for name, aus in ref.items():
        base = tone.get(name.split("_")[1])
        check(base is not None, f"{name}: no transmitter service")
        for i, au in enumerate(aus):
            check(au[:len(base)] == base and not any(au[len(base):]),
                  f"{name}: reference AU {i} is not the transmitted one")


class Reference:
    """The CPU host path's decode of one capture, run in a subprocess."""

    def __init__(self, cap: str, workdir: str):
        self.dir = os.path.join(workdir, "reference")
        self._log = open(os.path.join(workdir, "reference.log"), "w+")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "dab_radio_tpu.apps.radio_cli",
             "--backend", "cpu", "-i", cap, "-F", "u8", "--benchmark",
             "--scraper-enable", "--scraper-output", self.dir],
            cwd=ROOT, env=cpu_env(), stdout=subprocess.DEVNULL,
            stderr=self._log)
        self.aus = None

    def result(self, timeout: float = 900) -> dict:
        if self.aus is None:
            rc = self._proc.wait(timeout=timeout)
            self._log.seek(0)
            check(rc == 0, f"reference decode failed: "
                           f"{self._log.read()[-800:]}")
            self.aus = scraped_aus(self.dir)
            check(len(self.aus) == SERVICES and all(self.aus.values()),
                  f"reference decoded {len(self.aus)} channels")
            check_tone_payload(self.aus)
        return self.aus

    def per_subchannel(self) -> list:
        """AU lists in subchannel order (services F123, F124, ... sit on
        CU 0, 48, ...)."""
        ref = self.result()
        return [ref[k] for k in sorted(ref)]

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._log.close()


def make_capture(frames: int) -> tuple:
    from _capture import capture_path
    cap = capture_path(SERVICES, frames)
    return cap, np.fromfile(cap, np.uint8)


# ---- one card -----------------------------------------------------------

@contextlib.contextmanager
def captured_stderr():
    """Collect everything written to file descriptor 2 (the apps print
    their summaries to sys.stderr)."""
    buf = {"text": ""}
    with tempfile.TemporaryFile() as tf:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(tf.fileno(), 2)
        try:
            yield buf
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            tf.seek(0)
            buf["text"] = tf.read().decode(errors="replace")


def phase_radio_cli(cap: str, ref: Reference, workdir: str) -> dict:
    from dab_radio_tpu.apps import radio_cli
    out = os.path.join(workdir, "radio_cli")
    t0 = time.perf_counter()
    with captured_stderr() as err:
        rc = radio_cli.main(["-i", cap, "-F", "u8", "--benchmark",
                             "--scraper-enable", "--scraper-output", out])
    wall = time.perf_counter() - t0
    text = err["text"]
    check(rc == 0, f"radio_cli exited {rc}: {text[-800:]}")
    summary = text[text.rfind("ensemble: "):]
    check("ensemble: id=C0FE" in summary, f"no ensemble C0FE: {text[-800:]}")
    services = summary.count("  service ")
    check(services == SERVICES, f"{services} services found")
    got, want = scraped_aus(out), ref.result()
    check(sorted(got) == sorted(want),
          f"channels {sorted(got)} vs reference {sorted(want)}")
    nb = 0
    for name in want:
        bad = au_mismatches(got[name], want[name])
        check(not bad, f"radio_cli {name}: {'; '.join(bad)}")
        nb += len(got[name])
    check(nb > 0, "radio_cli decoded no AUs")
    return {"ensemble": "C0FE", "services": services, "access_units": nb,
            "au_bytes_equal": True, "wall_seconds": wall}


def run_fleet(iq: np.ndarray, ref_subs: list, nb_streams: int, K: int,
              mesh=None) -> dict:
    """bench.serve_rounds over the capture, then every (stream,
    subchannel) AU byte stream against the reference."""
    from bench import serve_rounds
    aus = [[[] for _ in ref_subs] for _ in range(nb_streams)]
    res = serve_rounds(iq, nb_streams, K, mesh=mesh,
                       on_access_unit=lambda b, s, i, n, au, h:
                       aus[b][s].append(bytes(au)))
    bad = [f"stream {b} subchannel {s}: {m}"
           for b in range(nb_streams) for s, ref in enumerate(ref_subs)
           for m in au_mismatches(aus[b][s], ref)]
    check(not bad, "fleet AU bytes differ from the reference: "
                   + "; ".join(bad[:8]))
    return {**res, "au_bytes_equal": True}


def kernel_checks(iq: np.ndarray, dev, cpu, demod_batch: int = 16,
                  acs_batch: int = 16384, fic_batch: int = 1024,
                  rs_batch: int = 4096) -> dict:
    """Each kernel on `dev` against the plain reference on `cpu`."""
    import jax
    import jax.numpy as jnp
    from dab_radio_tpu.models.demodulator import DemodCarry, OFDMDemodulator
    from dab_radio_tpu.ops import rs
    from dab_radio_tpu.ops import viterbi as vit
    from dab_radio_tpu.params import (SubchannelConfig, fic_puncture_schedule,
                                      msc_puncture_schedule)
    out = {"precision": "f32 matmuls at JAX's default precision (TF32 "
                        "allowed); exact because every operand is a small "
                        "integer and every sum stays below 2^24"}
    rng = np.random.default_rng(0)

    # demod frame step, vmapped over frame-aligned windows of the capture
    demod = OFDMDemodulator(1)
    fs, wl = demod.params.nb_frame_samples, demod.window_len
    u = iq[:2 * ((demod_batch - 1) * fs + wl)].astype(np.float32)
    c = ((u - 127.5) / 127.5).reshape(-1, 2)
    win = np.stack([c[k * fs:k * fs + wl] for k in range(demod_batch)])
    step = jax.jit(jax.vmap(demod._frame_step_impl))
    carry = DemodCarry.init((demod_batch,))

    def run_step(d):
        _, o = step(jax.device_put(carry, d), jax.device_put(win, d))
        return (np.asarray(o["bits"]).astype(np.int16),
                np.asarray(o["sync_ok"]))
    (g, g_ok), (r, r_ok) = run_step(dev), run_step(cpu)
    within = float(np.mean(np.abs(g - r) <= 1))
    nz = r != 0
    hard = float(np.mean(np.sign(g[nz]) == np.sign(r[nz])))
    out["demod"] = {"batch": demod_batch, "soft_within_1": within,
                    "hard_agreement_nonzero": hard,
                    "sync_ok": int(g_ok.sum()),
                    "max_abs_diff": int(np.abs(g - r).max())}
    check(bool(r_ok.all()) and bool((g_ok == r_ok).all()),
          f"demod sync_ok {g_ok} vs {r_ok}")
    check(within >= SOFT_WITHIN_1 and hard >= HARD_AGREE,
          f"demod soft bits off the CPU reference: {out['demod']}")

    # radix-4 ACS + chainback vs the radix-2 decoder on the CPU
    msc = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(
        SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)))
    fic = vit.ViterbiSpec.from_schedule(fic_puncture_schedule())
    r4 = jax.jit(vit.viterbi_decode_soft_radix4)
    r2 = jax.jit(vit.viterbi_decode_soft)
    for name, spec, B in (("acs_eep3a_48cu", msc, acs_batch),
                          ("acs_fic", fic, fic_batch)):
        soft = rng.integers(-127, 128, (B, spec.nb_in)).astype(np.int8)
        d = np.asarray(jax.jit(lambda x, s=spec: vit.depuncture(x, s))(
            jax.device_put(soft, cpu)))
        gb, ge = (np.asarray(a) for a in r4(jax.device_put(d, dev)))
        rb, re_ = (np.asarray(a) for a in r2(jax.device_put(d, cpu)))
        out[name] = {"batch": B, "trellis_steps": spec.nb_steps,
                     "bits_equal": bool((gb == rb).all()),
                     "path_error_equal": bool((ge == re_).all())}
        check(out[name]["bits_equal"] and out[name]["path_error_equal"],
              f"{name}: radix-4 on the card differs from radix-2 on the CPU")

    # time per iteration of the radix-4 forward scan (B lanes, T/2 steps)
    T, B = msc.nb_steps, acs_batch
    xs = jax.device_put(jnp.asarray(rng.integers(
        -127, 128, (T // 2, 2, B, 4)).astype(np.float32)), dev)
    pm0 = jax.device_put(jnp.zeros((vit.NB_STATES, B), jnp.float32), dev)
    fwd = jax.jit(vit._radix4_forward_sm)
    jax.block_until_ready(fwd(pm0, xs))
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fwd(pm0, xs)
    jax.block_until_ready(res)
    per = (time.perf_counter() - t0) / reps
    out["acs_forward_scan"] = {"batch": B, "iterations": T // 2,
                               "seconds_per_scan": per,
                               "us_per_iteration": per / (T // 2) * 1e6}

    # RS(120,110) syndromes: clean codewords and corrupted ones
    nroots, pad = 10, 135
    n = 255 - pad
    msg = rng.integers(0, 256, (rs_batch, n - nroots)).astype(np.uint8)
    cw = np.stack([rs.rs_encode(m, nroots, pad) for m in msg[:256]]
                  + [rng.integers(0, 256, n).astype(np.uint8)
                     for _ in range(rs_batch - 256)])
    cw[:16, 5] ^= 0x21
    syn = np.asarray(jax.jit(lambda x: rs.rs_syndromes_device(
        x, nroots, pad))(jax.device_put(cw, dev)))
    ok = bool((syn == rs.rs_syndromes_numpy(cw, nroots, pad)).all())
    out["rs_syndromes"] = {"batch": rs_batch, "equal_numpy": ok}
    check(ok, "rs_syndromes_device differs from rs_syndromes_numpy")
    return out


def one_card(workdir: str) -> int:
    import jax
    devs = jax.devices()
    d0 = devs[0]
    check(d0.platform == "gpu", f"JAX found no GPU (platform "
                                f"{d0.platform!r}); refusing to run")
    cards = card_lines()
    for ln in cards:
        print(ln, flush=True)
    emit("device", devices=[str(d) for d in devs], kind=d0.device_kind,
         cards=cards)
    from dab_radio_tpu.utils.cache import enable_compile_cache
    emit("compile_cache", dir=enable_compile_cache())

    K, streams, rounds = 16, 16, 6
    note("synthesizing the capture")
    t0 = time.perf_counter()
    cap, iq = make_capture(rounds * K + 1)
    ref = Reference(cap, workdir)
    try:
        synth_s = time.perf_counter() - t0
        note("radio_cli on the card")
        r3 = phase_radio_cli(cap, ref, workdir)
        ref_subs = ref.per_subchannel()
        emit("capture", frames=rounds * K + 1, synth_seconds=synth_s,
             reference_aus=[len(a) for a in ref_subs],
             transmitter_payload_equal=True)
        emit("radio_cli", **r3)
        note(f"fleet {streams} streams x K={K}")
        emit("fleet", card=cards[0], **run_fleet(iq, ref_subs, streams, K))
        note("kernels")
        emit("kernels", card=cards[0],
             **kernel_checks(iq, d0, jax.devices("cpu")[0]))
    finally:
        ref.close()
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


# ---- four cards ---------------------------------------------------------

def serve_pod(cap: str, ref_subs: list, streams: int, K: int) -> dict:
    """tools/serve_pod.py with one fleet_serve worker per card."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "serve_pod.py"),
         "--workers", "4", "-i", cap, "--shared-input",
         "--streams-per-worker", str(streams), "--subchannels", SUBCHANNELS,
         "--frames-per-step", str(K), "--base-port", "18950"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    check(r.returncode == 0 and lines,
          f"serve_pod exited {r.returncode}: {r.stderr[-1500:]}")
    pod = json.loads(lines[-1])
    check(pod["workers_reporting"] == 4,
          f"{pod['workers_reporting']} of 4 workers reported: "
          f"{r.stderr[-1500:]}")
    per_worker = streams * sum(len(a) for a in ref_subs)
    check(pod["access_units"] == 4 * per_worker,
          f"pod decoded {pod['access_units']} AUs, the reference "
          f"{4 * per_worker}")
    return {"workers": pod["workers"], "streams": pod["streams"],
            "access_units": pod["access_units"],
            "reference_access_units": 4 * per_worker}


def four_cards(workdir: str) -> int:
    cards = card_lines()
    check(len(cards) >= 4, f"{len(cards)} cards visible; 4 needed")
    for ln in cards:
        print(ln, flush=True)
    K, streams, rounds = 8, 16, 6
    cap, iq = make_capture(rounds * 2 * K + 1)
    ref = Reference(cap, workdir)
    try:
        ref_subs = ref.per_subchannel()
        note("serve_pod, one worker per card")
        emit("serve_pod", cards=cards,
             **serve_pod(cap, ref_subs, streams, 2 * K))
        import jax
        devs = jax.devices()
        check(devs[0].platform == "gpu" and len(devs) == 4,
              f"JAX sees {devs}; 4 GPUs needed")
        from dab_radio_tpu.parallel.mesh import make_receiver_mesh
        for sizes in ((4, 1, 1), None):
            mesh = make_receiver_mesh(4, axis_sizes=sizes)
            note(f"sharded fleet on {dict(mesh.shape)}")
            emit("mesh_fleet", layout=dict(mesh.shape),
                 **run_fleet(iq, ref_subs, streams, K, mesh=mesh))
    finally:
        ref.close()
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: only the multi-card paths, on four cards")
    args = ap.parse_args(argv)
    # the plain references run on the CPU backend of this same process
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.cards == 4:
            return four_cards(workdir)
        return one_card(workdir)


if __name__ == "__main__":
    sys.exit(main())
