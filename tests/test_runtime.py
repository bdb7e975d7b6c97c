"""Runtime plumbing for the GPU deployment: compile cache, --backend flags,
one card per serve_pod worker, chip_smoke.py's refusal and comparison,
exactness of the f32 matmuls under TF32, and the device fields of bench.py
records. Everything here runs on the CPU."""

import contextlib
import importlib
import importlib.util
import io
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path: str):
    """Import a script (tools/*.py, chip_smoke.py, bench.py) by path."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- compile cache --------------------------------------------------------

@contextlib.contextmanager
def _restore_cache_config():
    import jax
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        yield jax.config
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    from dab_radio_tpu.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with _restore_cache_config() as cfg:
        before = cfg.jax_compilation_cache_dir
        assert cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself: no directory is set in code
        assert cfg.jax_compilation_cache_dir == before
    assert not os.path.exists(os.path.join(tmp_path, "x"))


def test_compile_cache_fixed_checkout_dir(monkeypatch):
    from dab_radio_tpu.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    with _restore_cache_config() as cfg:
        first = cache.enable_compile_cache()
        second = cache.enable_compile_cache()
        assert first == second == os.path.join(ROOT, ".jax_cache")
        assert cfg.jax_compilation_cache_dir == first
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---- --backend -------------------------------------------------------------

_CLIS = [
    ("dab_radio_tpu.apps.apply_frequency_shift", []),
    ("dab_radio_tpu.apps.ber_sweep", []),
    ("dab_radio_tpu.apps.convert_viterbi", []),
    ("dab_radio_tpu.apps.fleet_serve", ["-i", "x.u8"]),
    ("dab_radio_tpu.apps.loop_file", []),
    ("dab_radio_tpu.apps.monitor", []),
    ("dab_radio_tpu.apps.radio_app", []),
    ("dab_radio_tpu.apps.radio_cli", []),
    ("dab_radio_tpu.apps.simulate_transmitter", []),
    ("dab_radio_tpu.apps.tui", []),
    ("dab_radio_tpu.apps.webmon", []),
    ("tools/bench_fleet.py", []),
    ("tools/bench_stages.py", []),
    ("tools/serve_pod.py", ["-i", "x.u8"]),
    ("tools/soak.py", []),
]


def _main_exit(mod, argv):
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err), \
            pytest.raises(SystemExit) as e:
        mod.main(argv)
    return e.value.code, err.getvalue()


@pytest.mark.parametrize("cli,extra", _CLIS, ids=[c for c, _ in _CLIS])
def test_backend_flag_offers_gpu_not_tpu(cli, extra):
    mod = _load(cli) if cli.endswith(".py") else importlib.import_module(cli)
    # argparse validates --backend as it consumes it, before --help exits
    code, _ = _main_exit(mod, extra + ["--backend", "gpu", "--help"])
    assert code == 0
    code, err = _main_exit(mod, extra + ["--backend", "tpu"])
    assert code == 2 and "invalid choice: 'tpu'" in err


def test_shared_backend_flag_choices():
    import argparse
    from dab_radio_tpu.utils.backend import BACKENDS, add_backend_flag
    ap = argparse.ArgumentParser()
    add_backend_flag(ap)
    assert ap.parse_args(["--backend", "gpu"]).backend == "gpu"
    assert ap.parse_args([]).backend == "default"
    assert "tpu" not in BACKENDS


# ---- serve_pod: one card per worker ---------------------------------------

def _pod_args(**kw):
    base = dict(input="cap.u8", streams_per_worker=16, frames_per_step=16,
                base_port=8950, backend="default", subchannels="0:48:EEP3A",
                max_rounds=0, snapshot_dir=None, workers=4)
    base.update(kw)
    return SimpleNamespace(**base)


def test_serve_pod_pins_each_worker_to_its_card():
    pod = _load("tools/serve_pod.py")
    args = _pod_args()
    for k in range(4):
        cmd, env = pod.worker_command(args, k, environ={"PATH": "/bin"})
        assert env["CUDA_VISIBLE_DEVICES"] == str(k)
        assert env["PATH"] == "/bin"
        assert cmd[2] == "dab_radio_tpu.apps.fleet_serve"
        assert cmd[cmd.index("--port") + 1] == str(8950 + k)
        assert cmd[cmd.index("--backend") + 1] == "default"


def test_serve_pod_narrows_an_inherited_card_list():
    pod = _load("tools/serve_pod.py")
    args = _pod_args(workers=2, snapshot_dir="snaps", backend="gpu")
    env_in = {"CUDA_VISIBLE_DEVICES": "2,3"}
    cmd, env = pod.worker_command(args, 1, environ=env_in)
    assert env["CUDA_VISIBLE_DEVICES"] == "3"
    assert env_in["CUDA_VISIBLE_DEVICES"] == "2,3"
    assert cmd[cmd.index("--snapshot-out") + 1] == os.path.join(
        "snaps", "worker1.snap")
    assert cmd[cmd.index("--backend") + 1] == "gpu"
    with pytest.raises(ValueError):
        pod.worker_command(args, 2, environ=env_in)


# ---- chip_smoke.py ---------------------------------------------------------

def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_au_comparison_flags_one_byte():
    cs = _load("chip_smoke.py")
    ref = [bytes([i]) * 40 for i in range(5)]
    assert cs.au_mismatches(list(ref), ref) == []
    got = list(ref)
    got[3] = got[3][:17] + bytes([got[3][17] ^ 1]) + got[3][18:]
    assert cs.au_mismatches(got, ref) == ["AU 3 differs (40 vs 40 bytes)"]
    assert cs.au_mismatches(ref[:4], ref)


def test_chip_smoke_splits_scraper_adts_stream():
    from dab_radio_tpu.dab.aac import SuperFrameHeader, adts_header
    cs = _load("chip_smoke.py")
    hdr = SuperFrameHeader(sampling_rate=48000, is_stereo=True, sbr=True,
                           ps=False, mpeg_surround=0)
    aus = [b"\x01\x02\x03", bytes(range(200)), b"\xff" * 9]
    stream = b"".join(adts_header(hdr, len(a)) + a for a in aus)
    assert cs.split_adts(stream) == aus
    with pytest.raises(RuntimeError):
        cs.split_adts(b"\x00" + stream)


# ---- f32 matmuls stay exact under TF32 ------------------------------------

def _tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 explicit mantissa bits, nearest-even)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def _tf32_matmul(a, b):
    # TF32 operands, f32 accumulation
    return (_tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)
            ).astype(np.float32)


def _acs_operands(rng):
    from dab_radio_tpu.ops import viterbi as vit
    St = vit._branch_sign_matrix().T.astype(np.float32)          # (128, 4)
    d = rng.integers(-127, 128, (4, 512)).astype(np.float32)
    return St, d


def _lut_operands(rng):
    from dab_radio_tpu.ops import viterbi as vit
    _, H = vit._branch_pattern_lut()                             # (16, 4)
    return H, rng.integers(-127, 128, (4, 512)).astype(np.float32)


def _rs_operands(rng):
    from dab_radio_tpu.ops import rs
    M = rs.syndrome_bit_matrix(10, 135).astype(np.float32)       # (960, 80)
    bits = rng.integers(0, 2, (64, M.shape[0])).astype(np.float32)
    return bits, M


@pytest.mark.parametrize("operands", [_acs_operands, _lut_operands,
                                      _rs_operands],
                         ids=["acs_branch", "acs_lut", "rs_syndrome"])
def test_matmul_exact_under_tf32(operands):
    a, b = operands(np.random.default_rng(5))
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(_tf32(a), a)
    np.testing.assert_array_equal(_tf32(b), b)
    np.testing.assert_array_equal(_tf32_matmul(a, b), exact)


def test_tf32_emulation_rounds():
    # 2049 needs 12 significant bits: TF32 cannot hold it
    assert _tf32(np.float32(2049.0)) == np.float32(2048.0)
    assert _tf32(np.float32(127.0)) == np.float32(127.0)


# ---- no TPU-only code -------------------------------------------------------

def test_no_module_imports_pallas_tpu():
    needle = "pallas." + "tpu"
    hits = []
    for base, dirs, files in os.walk(ROOT):
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(base, fn)) as f:
                    if needle in f.read():
                        hits.append(os.path.join(base, fn))
    assert hits == []


# ---- bench.py records -------------------------------------------------------

_DEVICE_FIELDS = {"platform", "device_kind", "device_count", "cards"}


@pytest.mark.parametrize("measure,kw", [
    ("measure_demod", dict(batch=2, iters=1)),
    ("measure_viterbi", dict(batch=8, iters=1)),
], ids=["demod", "viterbi"])
def test_bench_records_carry_device_fields(measure, kw):
    bench = _load("bench.py")
    rec = getattr(bench, measure)(**kw)
    assert _DEVICE_FIELDS <= set(rec)
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert rec["value"] > 0 and rec["unit"]


def test_bench_refuses_cpu():
    bench = _load("bench.py")
    with contextlib.redirect_stderr(io.StringIO()) as err:
        assert bench.main() == 1
    assert "needs a GPU" in err.getvalue()
