"""Golden-vector parity against the COMPILED C++ reference.

Builds tests/golden/ref_harness.cpp against the reference sources at
/root/reference (read-only; nothing is copied) and compares its dumped
tables/outputs with this framework: OFDM params, PRS reference, carrier map,
puncture vectors, the 64-row UEP table, energy-dispersal PRBS, CRC16s, and
Reed-Solomon decode results on identical corrupted codewords.

Skipped when the reference tree or a C++ toolchain is unavailable.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

REF = "/root/reference/src"
HERE = os.path.dirname(os.path.abspath(__file__))
HARNESS = os.path.join(HERE, "golden", "ref_harness.cpp")

pytestmark = pytest.mark.skipif(
    not (os.path.isdir(REF) and shutil.which("g++")),
    reason="reference sources or g++ unavailable")


@pytest.fixture(scope="module")
def golden():
    exe = "/tmp/dab_golden_harness"
    srcs = [HARNESS,
            f"{REF}/ofdm/dab_ofdm_params_ref.cpp",
            f"{REF}/ofdm/dab_prs_ref.cpp",
            f"{REF}/ofdm/dab_mapper_ref.cpp",
            f"{REF}/dab/algorithms/reed_solomon_decoder.cpp"]
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{REF}",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe] + srcs,
                   check=True, capture_output=True)
    out = subprocess.run([exe], check=True, capture_output=True,
                         timeout=120).stdout.decode()
    data = {}
    for line in out.splitlines():
        parts = line.split()
        data.setdefault(parts[0], []).append(parts[1:])
    return data


def test_ofdm_params_match(golden):
    from dab_radio_tpu.params import get_ofdm_params
    for row in golden["ofdm_params"]:
        mode, syms, sym_p, null_p, cp, nfft, ncarr = map(int, row)
        p = get_ofdm_params(mode)
        assert (p.nb_frame_symbols, p.nb_symbol_period, p.nb_null_period,
                p.nb_cyclic_prefix, p.nb_fft, p.nb_data_carriers) == \
            (syms, sym_p, null_p, cp, nfft, ncarr), mode


def test_prs_reference_matches(golden):
    from dab_radio_tpu.params import get_prs_reference
    for row in golden["prs"]:
        mode, nfft = int(row[0]), int(row[1])
        vals = np.array(row[2:], dtype=np.float64).reshape(nfft, 2)
        ref = vals[:, 0] + 1j * vals[:, 1]
        ours = np.asarray(get_prs_reference(mode, nfft))
        np.testing.assert_allclose(ours, ref, atol=2e-5), mode


def test_carrier_map_matches(golden):
    from dab_radio_tpu.params import get_ofdm_params
    from dab_radio_tpu.params.mapper import get_carrier_mapper
    for row in golden["carrier_map"]:
        mode, ncarr = int(row[0]), int(row[1])
        ref = np.array(row[2:], dtype=np.int64)
        p = get_ofdm_params(mode)
        ours = np.asarray(get_carrier_mapper(p.nb_fft, ncarr))
        np.testing.assert_array_equal(ours, ref), mode


def test_puncture_vectors_match(golden):
    from dab_radio_tpu.params.puncture import get_puncture_vector, PI_X_VECTOR
    for row in golden["pi"]:
        pi = int(row[0])
        ref_counts = [int(x) for x in row[1:]]
        # reference stores per-8-symbol keep counts; our vector is the
        # expanded 32-bit keep mask — compare via group sums
        vec = np.asarray(get_puncture_vector(pi)).reshape(8, 4)
        assert vec.sum(axis=1).tolist() == ref_counts, pi
    ref_x = [int(x) for x in golden["pi_x"][0]]
    assert np.asarray(PI_X_VECTOR).reshape(6, 4).sum(axis=1).tolist() == ref_x


def test_uep_table_matches(golden):
    from dab_radio_tpu.params.protection import UEP_TABLE
    # known intentional divergence: the reference swaps the subchannel sizes
    # of the 128 kbps level-5/4 rows (indices 33/34); ours follows ETSI
    # table 8 (coded-bit budget balances, see protection.py NOTE)
    known_diff = {33, 34}
    for row in golden["uep"]:
        i = int(row[0])
        size, bitrate, level = int(row[1]), int(row[2]), int(row[3])
        lx = tuple(int(x) for x in row[4:8])
        pix = tuple(int(x) for x in row[8:12])
        pad = int(row[12])
        ours = UEP_TABLE[i]
        if i in known_diff:
            assert ours.subchannel_size != size
            continue
        assert (ours.subchannel_size, ours.bitrate_kbps,
                ours.protection_level, ours.Lx, ours.PIx,
                ours.padding_bits) == (size, bitrate, level, lx, pix, pad), i


def test_scrambler_matches(golden):
    from dab_radio_tpu.ops.scrambler import prbs_bytes
    ref = np.array([int(x) for x in golden["scrambler"][0]], dtype=np.uint8)
    np.testing.assert_array_equal(prbs_bytes(64), ref)


def test_crc16_matches(golden):
    from dab_radio_tpu.ops.crc import crc16, firecode_crc16
    assert crc16(b"123456789") == int(golden["crc16_fib"][0][0])
    assert firecode_crc16(b"123456789") == int(golden["crc16_firecode"][0][0])


@pytest.mark.parametrize("name,nroots,pad", [("rs_dabplus", 10, 135),
                                             ("rs_packet", 16, 51)])
def test_rs_decode_matches(golden, name, nroots, pad):
    from dab_radio_tpu.ops.rs import ReedSolomonDecoder
    dec = ReedSolomonDecoder(nroots, pad)
    for row in golden[name]:
        trial, ref_nerr = int(row[0]), int(row[1])
        ref_cw = np.array(row[2:], dtype=np.uint8)
        # reconstruct the corrupted input the reference was fed: same LCG
        corrupted = _corrupt_like_harness(dec.n, trial)
        ours, nerr = dec.decode(corrupted[None])
        assert int(nerr[0]) == ref_nerr, (name, trial)
        if ref_nerr >= 0:
            np.testing.assert_array_equal(ours[0], ref_cw), (name, trial)


class _LCG:
    def __init__(self):
        self.state = 12345

    def next(self):
        self.state = (self.state * 1664525 + 1013904223) & 0xFFFFFFFF
        return self.state >> 16


_lcg = None


def _corrupt_like_harness(n, trial):
    """Replays the harness's deterministic corruption sequence. The harness
    iterates cases in order (rs_dabplus trials 0..5 then rs_packet 0..5),
    so we regenerate the full sequence once and index into it."""
    global _lcg_seq
    try:
        _lcg_seq
    except NameError:
        lcg = _LCG()
        _lcg_seq = []
        for nn in (120, 204):
            for t in range(6):
                cw = np.zeros(nn, np.uint8)
                for _ in range(t):
                    pos = lcg.next() % nn
                    cw[pos] ^= np.uint8(1 + lcg.next() % 255)
                _lcg_seq.append((nn, t, cw))
    for nn, t, cw in _lcg_seq:
        if nn == n and t == trial:
            return cw.copy()
    raise AssertionError("missing corruption case")


# ---------------- FIG processor differential ----------------

def _translate(ev) -> list:
    """Map one of our FIG event dataclasses onto the reference handler's
    printed line format (tests/golden/fig_harness.cpp)."""
    import dab_radio_tpu.dab.fig as F
    t = type(ev).__name__
    if t == "EnsembleInfo":
        return [f"ens_info {ev.ensemble_id} {ev.change_flags} "
                f"{ev.alarm_flag} {ev.cif_upper} {ev.cif_lower}"]
    if t == "SubchannelShort":
        return [f"subch_s {ev.subchannel_id} {ev.start_address} "
                f"{ev.table_switch} {ev.table_index}"]
    if t == "SubchannelLong":
        return [f"subch_l {ev.subchannel_id} {ev.start_address} {ev.option} "
                f"{ev.prot_level} {ev.subchannel_size}"]
    if t == "StreamComponent":
        kind = "comp_audio" if ev.is_audio else "comp_data"
        return [f"{kind} {ev.service_id} {ev.subchannel_id} {ev.ty} "
                f"{int(ev.is_primary)}"]
    if t == "PacketComponentRef":
        return [f"comp_packetref {ev.service_id} {ev.scid} "
                f"{int(ev.is_primary)}"]
    if t == "PacketComponent":
        return [f"packet_comp {ev.scid} {ev.subchannel_id} {ev.dscty} "
                f"{ev.packet_address}"]
    if t == "StreamCA":
        return [f"ca {ev.subchannel_id} {ev.ca_org}"]
    if t == "ComponentLanguage":
        if ev.subchannel_id is not None:
            return [f"lang_s {ev.subchannel_id} {ev.language}"]
        return [f"lang_l {ev.scid} {ev.language}"]
    if t == "ServiceLinkage":
        f3 = f"{int(ev.is_active_link)} {int(ev.is_hard_link)} " \
             f"{int(ev.is_international)} {ev.lsn}"
        out = []
        for sid in ev.service_ids:
            out.append(f"link_sid {f3} {sid}")
        for pi in ev.rds_pi_ids:
            out.append(f"link_rds {f3} {pi}")
        for d in ev.drm_ids:
            out.append(f"link_drm {f3} {d}")
        if not out and not getattr(ev, "has_id_list", False):
            out.append(f"link_lsn {f3}")
        return out
    if t == "ConfigurationInfo":
        return [f"config {ev.nb_services} {ev.reconfiguration_count}"]
    if t == "ComponentGlobalDefinition":
        if ev.subchannel_id is not None:
            return [f"gdef_s {ev.service_id} {ev.scids} {ev.subchannel_id}"]
        return [f"gdef_l {ev.service_id} {ev.scids} {ev.scid}"]
    if t == "EnsembleCountry":
        # the reference emits the ensemble-level callback only for the
        # non-extended form, per-service callbacks otherwise
        if getattr(ev, "has_extension", False):
            return [f"country_svc {ev.lto} {ev.ecc} "
                    f"{ev.international_table_id} {sid}"
                    for sid in ev.service_ids]
        return [f"country {ev.lto} {ev.ecc} {ev.international_table_id}"]
    if t == "DateTime":
        return [f"datetime {ev.mjd} {ev.hours} {ev.minutes} {ev.seconds} "
                f"{ev.milliseconds} {ev.lsi} {ev.has_utc}"]
    if t == "UserApplication":
        data = " ".join(str(b) for b in ev.app_data)
        line = f"userapp {ev.service_id} {ev.scids} {ev.app_type}"
        return [line + (" " + data if data else "")]
    if t == "SubchannelFEC":
        return [f"fec {ev.subchannel_id} {ev.fec_scheme}"]
    if t == "ProgrammeType":
        return [f"ptype {ev.service_id} {ev.international_code}"]
    if t == "FrequencyInfo":
        kind = {0b0000: "fi_ens", 0b1000: "fi_rds", 0b0110: "fi_drm",
                0b1110: "fi_amss"}.get(ev.rm)
        if kind is None:
            return []
        return [f"{kind} {ev.id_value} {ev.frequency_hz} "
                f"{int(ev.is_continuous)}"]
    if t == "OtherEnsembleService":
        return [f"oe {ev.service_id} {ev.ensemble_id}"]
    if t == "Label":
        kind = {"ensemble": "label_ens", "service": "label_svc",
                "component": "label_comp"}[ev.kind]
        if ev.kind == "component":
            return [f"{kind} {ev.id_value} {ev.scids} "
                    f"|{ev.label}|{ev.short_label}|"]
        return [f"{kind} {ev.id_value} |{ev.label}|{ev.short_label}|"]
    return [f"UNKNOWN {t}"]


def _norm_ref_line(line: str) -> str:
    """Normalize a harness line: labels keep trailing padding in the
    reference; strip each |segment|."""
    if "|" in line:
        head, *segs = line.split("|")
        segs = [s.rstrip() for s in segs if True]
        return head.rstrip() + " |" + "|".join(segs[:-1]) + "|"
    return line.strip()


@pytest.fixture(scope="module")
def fig_harness():
    exe = "/tmp/dab_fig_harness"
    srcs = [os.path.join(HERE, "golden", "fig_harness.cpp"),
            f"{REF}/dab/fic/fig_processor.cpp",
            f"{REF}/dab/constants/charsets.cpp"]
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{REF}",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe] + srcs,
                   check=True, capture_output=True)
    # ASan build flags which FIBs make the reference read out of bounds
    # (its 0/13 and 0/21 parsers trust internal length fields past the FIG
    # body); those inputs exercise undefined behaviour in the reference, so
    # they are excluded from the differential rather than mirrored
    exe_asan = exe + "_asan"
    subprocess.run(["g++", "-O1", "-g", "-std=c++17", "-DNDEBUG",
                    "-fsanitize=address", "-fsanitize-recover=address",
                    f"-I{REF}", f"-I{os.path.join(HERE, 'golden')}",
                    "-o", exe_asan] + srcs, check=True, capture_output=True)
    return exe


def _reference_oob_fibs(fibs) -> set:
    """Indices of FIBs on which the reference parser reads out of bounds."""
    stdin = "\n".join(f.hex() for f in fibs) + "\n"
    env = dict(os.environ,
               ASAN_OPTIONS="halt_on_error=0:detect_leaks=0:log_path=stderr")
    r = subprocess.run(["/tmp/dab_fig_harness_asan"], input=stdin.encode(),
                       capture_output=True, timeout=300, env=env)
    bad, cur = set(), -1
    for line in r.stderr.decode(errors="replace").splitlines():
        if line.startswith("fib "):
            cur = int(line.split()[1])
        elif "AddressSanitizer" in line and "ERROR" in line:
            bad.add(cur)
    return bad


def _fig0_13_overread_fibs(fibs) -> set:
    """Indices of FIBs where the reference's FIG 0/13 walk reads past the
    declared FIG body (fig_processor.cpp Ext_13 computes the per-app
    remaining-byte budget from the ENTITY start, forgetting to subtract
    the sid+descriptor header, so app headers/data may be read up to
    header-size bytes — and, chained across apps, arbitrarily far —
    beyond the FIG field, into whatever follows in the FIB buffer).
    Reads that stay inside the 30-byte FIB are invisible to ASan; this
    simulates the reference's exact arithmetic and flags any access at
    or past the FIG body end. Our parser mirrors the small in-FIB
    overreads but refuses ones past the buffer, so flagged FIBs are
    excluded from the event differential (docs/FINDINGS.md)."""
    bad = set()
    for idx, fib in enumerate(fibs):
        pos = 0
        while pos < len(fib):
            h = fib[pos]
            fig_type, fig_len = h >> 5, h & 0x1F
            if fig_type == 7 or fig_len == 0:        # end marker / padding
                break
            body = fib[pos + 1: pos + 1 + fig_len]
            tail = fib[pos + 2:]                     # field + rest of FIB
            if fig_type == 0 and len(body) >= 1 and (body[0] & 0x1F) == 13:
                pd = (body[0] >> 5) & 1
                sid_len = 4 if pd else 2
                hdr = sid_len + 1
                N = fig_len - 1                      # field length
                curr = 0
                over = False
                while curr != N and curr < N:
                    remain = N - curr
                    if hdr > remain:
                        break
                    if curr + hdr > len(tail):
                        break
                    nb_apps = tail[curr + sid_len] & 0x0F
                    ai = 0
                    stop = False
                    for _ in range(nb_apps):
                        app_remain = remain - ai     # reference's bug
                        if 2 > app_remain:
                            stop = True
                            break
                        if curr + hdr + ai + 2 > N:
                            over = True
                        if curr + hdr + ai + 2 > len(tail):
                            stop = True
                            break
                        nb_data = tail[curr + hdr + ai + 1] & 0x1F
                        if 2 + nb_data > app_remain:
                            stop = True
                            break
                        if curr + hdr + ai + 2 + nb_data > N:
                            over = True
                        ai += 2 + nb_data
                    if stop:
                        break
                    curr += hdr + ai
                if over:
                    bad.add(idx)
            pos += 1 + fig_len
    return bad


def _run_fig_harness(exe, fibs):
    stdin = "\n".join(f.hex() for f in fibs) + "\n"
    out = subprocess.run([exe], input=stdin.encode(), capture_output=True,
                         check=True, timeout=120
                         ).stdout.decode(errors="replace")
    per_fib, cur = [], None
    for line in out.splitlines():
        if line.startswith("fib "):
            cur = []
            per_fib.append(cur)
        elif cur is not None:
            cur.append(_norm_ref_line(line))
    return per_fib


def _fib_corpus():
    """Transmitter FIBs (all service kinds) + handcrafted FIGs covering the
    remaining extensions."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.dab.fic import FICEncoder

    tx = EnsembleTransmitter(1, services=[
        ServiceSpec(0xA001, 1, "Svc One",
                    SubchannelConfig(0, 48, False, eep_type="A",
                                     eep_prot_level=2)),
        ServiceSpec(0xA002, 2, "Svc MP2",
                    SubchannelConfig(48, 84, True, uep_table_index=33),
                    kind="dab"),
        ServiceSpec(0xA003, 3, "Svc Data",
                    SubchannelConfig(132, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="packet",
                    scid=0x10, packet_address=2),
    ])
    enc = FICEncoder(1)
    fibs = [bytes(enc.encode_fib_payload(p))[:30]
            for p in tx._fib_payloads()]

    def fig(t, body):
        return bytes([(t << 5) | len(body)]) + bytes(body)

    def fib_of(*figs):
        buf = b"".join(figs)
        return (buf + b"\xff" + b"\x00" * 29)[:30]

    hand = [
        # 0/4 CA, 0/5 languages short+long
        fib_of(fig(0, [0x04, 0x05, 0x12, 0x34]),
               fig(0, [0x05, 0x07, 42, 0x80 | 0x02, 0x10, 7])),
        # 0/6 linkage: lsn-only, sid list, rds list (intl), drm list
        fib_of(fig(0, [0x06, 0x40 | 0x02, 0x22]),
               fig(0, [0x06, 0xC0 | 0x01, 0x11, 0x02, 0xAB, 0xCD, 0x12, 0x34])),
        fib_of(fig(0, [0x06, 0x90 | 0x01, 0x55, 0x20 | 0x02,
                       0xEE, 0xBE, 0xEF, 0xEE, 0xCA, 0xFE])),
        fib_of(fig(0, [0x06, 0x80 | 0x01, 0x66, 0x60 | 0x01,
                       0x00, 0x01, 0x02, 0x03])),
        # 0/7 config, 0/8 gdef short + long
        fib_of(fig(0, [0x07, (5 << 2) | 0x01, 0x44]),
               fig(0, [0x08, 0xA0, 0x01, 0x05, 0x12]),
               fig(0, [0x08, 0xA0, 0x02, 0x03, 0x81, 0x23])),
        # 0/9 country with extension, 0/10 datetime short + long
        fib_of(fig(0, [0x09, 0x80 | 0x12, 0xE0, 0x01,
                       0x40, 0xE1, 0xAB, 0xCD]),
               fig(0, [0x0A, 0x3A, 0x5B, 0x27, 0x45])),
        fib_of(fig(0, [0x0A, 0x3A, 0x5B, 0x2F, 0x45, 0x8F, 0x12])),
        # 0/13 user app, 0/17 programme type
        fib_of(fig(0, [0x0D, 0xA0, 0x01, 0x21, 0x02,
                       (0x44 << 3 >> 8), 0x46, 0xDE, 0xAD][:9]),
               fig(0, [0x11, 0xA0, 0x05, 0x00, 0x10])),
        # 0/21 frequency info rm=0 and rm=8
        fib_of(fig(0, [0x15, 0x00, 0x06, 0xC1, 0x85, 0x01, 0x06, 0x1A, 0xB0]),
               fig(0, [0x15, 0x00, 0x05, 0xAB, 0xCD, 0x81, 0x30, 0x55])),
        # 0/24 other ensembles
        fib_of(fig(0, [0x18, 0xB0, 0x01, 0x01, 0xC0, 0xFF])),
        # 1/4 component label, 1/5 long service label
        fib_of(fig(1, [0x04, 0x02, 0xA0, 0x05]
                   + list(b"Component Lbl   ") + [0xFF, 0x00])),
        fib_of(fig(1, [0x05, 0xE0, 0x00, 0x00, 0x07]
                   + list(b"Long Svc Label  ") + [0xFF, 0x00])),
    ]
    return fibs + hand


def test_fig_processor_matches(fig_harness):
    from dab_radio_tpu.dab.fig import FIGParser
    fibs = _fib_corpus()
    ref = _run_fig_harness(fig_harness, fibs)
    parser = FIGParser()
    mismatches = []
    for i, fib in enumerate(fibs):
        ours = []
        for ev in parser.parse_fib(fib):
            ours.extend(_translate(ev))
        ours = [_norm_ref_line(x) for x in ours]
        if ours != ref[i]:
            mismatches.append((i, fib.hex(), ref[i], ours))
    assert not mismatches, "\n".join(
        f"fib {i} {h}\n  ref : {r}\n  ours: {o}"
        for i, h, r, o in mismatches[:6])


def test_fig_processor_fuzz_matches(fig_harness):
    """Structured fuzz: random bodies with valid-looking FIG headers across
    every supported extension, compared event-for-event against the compiled
    reference processor."""
    from dab_radio_tpu.dab.fig import FIGParser
    rng = np.random.default_rng(4242)
    exts = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 13, 14, 17, 21, 24]
    fibs = []
    # 5000 FIBs: an extended 20k-FIB session (4 seeds) found the 0/13
    # overread class at ~1/2000 — this corpus keeps several instances in
    # every run so the exclusion stays exercised
    for _ in range(5000):
        body_len = int(rng.integers(1, 28))
        fig_type = int(rng.choice([0, 0, 0, 1]))
        body = rng.integers(0, 256, body_len, dtype=np.uint8)
        if fig_type == 0:
            body[0] = (int(rng.integers(0, 8)) << 5) | int(rng.choice(exts))
        else:
            # charset fixed to EBU Latin: unknown charsets pass raw bytes
            # through the reference (not valid UTF-8), and non-table
            # charsets are covered by the explicit-label corpus
            body[0] = int(rng.choice([0, 1, 4, 5]))
        fib = bytes([(fig_type << 5) | body_len]) + body.tobytes()
        fibs.append((fib + b"\xff" * 30)[:30])

    ref = _run_fig_harness(fig_harness, fibs)
    # excluded: FIBs where the reference itself reads out of bounds (ASan)
    # or past the FIG 0/13 body into the FIB tail (its missing-header
    # budget bug, docs/FINDINGS.md) — its events there are artifacts of
    # reading other FIGs' bytes/padding, not parses to mirror
    skip = _reference_oob_fibs(fibs) | _fig0_13_overread_fibs(fibs)
    parser = FIGParser()
    mismatches = []
    checked = 0
    for i, fib in enumerate(fibs):
        if i in skip:
            continue
        checked += 1
        ours = []
        for ev in parser.parse_fib(fib):
            ours.extend(_translate(ev))
        ours = [_norm_ref_line(x) for x in ours]
        if ours != ref[i]:
            mismatches.append((i, fib.hex(), ref[i], ours))
    assert checked > len(fibs) * 3 // 4, (checked, len(skip))
    assert not mismatches, (
        f"{len(mismatches)} mismatching FIBs ({checked} checked); first 5:\n"
        + "\n".join(f"fib {i} {h}\n  ref : {r}\n  ours: {o}"
                     for i, h, r, o in mismatches[:5]))


# ---------------- DAB+ superframe + CIF deinterleaver differential ----------

@pytest.fixture(scope="module")
def sf_harness():
    exe = "/tmp/dab_sf_harness"
    srcs = [os.path.join(HERE, "golden", "superframe_harness.cpp"),
            f"{REF}/dab/audio/aac_frame_processor.cpp",
            f"{REF}/dab/msc/cif_deinterleaver.cpp",
            f"{REF}/dab/algorithms/reed_solomon_decoder.cpp"]
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{REF}",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe] + srcs,
                   check=True, capture_output=True)
    return exe


def _run_sf_harness(exe, cmds):
    stdin = "\n".join(f"{c} {d.hex()}" for c, d in cmds) + "\n"
    out = subprocess.run([exe], input=stdin.encode(), capture_output=True,
                         check=True, timeout=300).stdout.decode()
    per, cur = [], None
    for line in out.splitlines():
        if line.startswith("input "):
            cur = []
            per.append(cur)
        elif cur is not None:
            cur.append(line)
    return per


@pytest.mark.parametrize("hdr_args", [
    (48000, False, True, True, 0),    # 48k SBR+PS: 3 AUs
    (48000, True, False, False, 0),   # 48k plain stereo: 6 AUs
    (32000, False, True, False, 0),   # 32k SBR: 2 AUs
    (32000, True, False, False, 0),   # 32k plain: 4 AUs
])
def test_superframe_matches_reference(sf_harness, hdr_args):
    """Valid and RS-corrupted superframes: AU extraction, header decode, and
    error callbacks must match the compiled reference, across the four
    (dac_rate, sbr) AU-count layouts."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dab_radio_tpu.dab.aac import (SuperframeEncoder, SuperframeProcessor,
                                       SuperFrameHeader)
    rng = np.random.default_rng(55)
    frame_bytes = 384          # 16 kB/s subchannel-ish
    hdr = SuperFrameHeader(*hdr_args)
    enc = SuperframeEncoder(frame_bytes, hdr)

    cap = enc.au_capacity()
    num_aus = hdr.num_aus
    frames = []
    for sf in range(8):
        sizes = [cap // num_aus] * num_aus
        sizes[-1] += cap - sum(sizes)
        aus = [rng.integers(0, 256, sz).astype(np.uint8).tobytes()
               for sz in sizes]
        frames.extend(enc.encode(aus))
    # corrupt superframe 5 with correctable RS errors (4 per codeword col)
    base = 5 * 5
    for f in range(5):
        frames[base + f] = bytearray(frames[base + f])
    for col in range(0, frame_bytes * 5 // 120):
        for e in range(4):
            pos = int(rng.integers(0, 120))
            glob = col * 120 + pos
            frames[base + glob // frame_bytes][glob % frame_bytes] ^= 0x55
    frames = [bytes(f) for f in frames]

    ref = _run_sf_harness(sf_harness, [("F", f) for f in frames])

    proc = SuperframeProcessor()
    ours_events = []
    for k, f in enumerate(frames):
        evs = []
        res = proc.process_frame(f)
        if res is not None:
            h, aus = res
            # the reference notifies the header on every decoded superframe
            evs.append(f"header {h.sampling_rate} {int(h.ps)} "
                       f"{int(h.sbr)} {int(h.is_stereo)} "
                       f"{h.mpeg_surround}")
            for i, au in enumerate(aus):
                evs.append(f"au {i} {len(aus)} "
                           + " ".join(str(b) for b in au))
        ours_events.append(evs)

    def flat(seq):
        return [ln for evs in seq for ln in evs
                if ln.startswith(("header", "au "))]
    assert flat(ours_events) == flat(ref)


def test_cif_deinterleaver_matches_reference(sf_harness):
    from dab_radio_tpu.ops.deinterleave import (make_gather_index,
                                                deinterleave_push, DEPTH)
    import jax.numpy as jnp
    rng = np.random.default_rng(77)
    nb = 256
    cifs = rng.integers(-127, 128, size=(24, nb)).astype(np.int8)
    ref = _run_sf_harness(sf_harness,
                          [("D", c.astype(np.uint8).tobytes()) for c in cifs])

    hist = jnp.zeros((DEPTH, nb), jnp.int8)
    gidx = jnp.asarray(make_gather_index(nb))
    for t in range(24):
        hist, out = deinterleave_push(hist, jnp.asarray(cifs[t]), gidx)
        ref_lines = [l for l in ref[t] if l.startswith("deint")]
        assert len(ref_lines) == 1
        if ref_lines[0] == "deint_pending":
            assert t < DEPTH - 1
            continue
        ref_vals = np.array([int(x) for x in ref_lines[0].split()[1:]],
                            dtype=np.int8)
        np.testing.assert_array_equal(np.asarray(out), ref_vals), t


# ---------------- PAD / dynamic label / MOT differential ----------------

@pytest.fixture(scope="module")
def pad_harness():
    exe = "/tmp/dab_pad_harness"
    import glob
    srcs = ([os.path.join(HERE, "golden", "pad_harness.cpp")]
            + sorted(glob.glob(f"{REF}/dab/pad/*.cpp"))
            + [f"{REF}/dab/audio/aac_data_decoder.cpp",
               f"{REF}/dab/mot/MOT_processor.cpp",
               f"{REF}/dab/mot/MOT_assembler.cpp",
               f"{REF}/dab/msc/msc_data_group_processor.cpp",
               f"{REF}/dab/constants/charsets.cpp"])
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{REF}",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe] + srcs,
                   check=True, capture_output=True)
    return exe


def _run_pad_harness(exe, fields):
    stdin = "\n".join(f"P {f.hex()}|{x.hex()}" for f, x in fields) + "\n"
    out = subprocess.run([exe], input=stdin.encode(), capture_output=True,
                         check=True, timeout=300).stdout.decode()
    events = [l for l in out.splitlines() if not l.startswith("input ")]
    return events


def _run_our_pad(fields):
    from dab_radio_tpu.dab.pad import PADProcessor
    pad = PADProcessor()
    events = []
    pad.on_label.append(
        lambda label: events.append(f"label |{label.encode().hex()}|"))
    pad.on_mot_entity.append(lambda e: events.append(
        f"mot {e.transport_id} {e.header.content_type} "
        f"{e.header.content_sub_type} "
        f"{e.header.content_name.encode().hex() if e.header.content_name else '-'} "
        f"{bytes(e.body).hex()}"))
    for f, x in fields:
        pad.process(f, x)
    return events


def test_pad_dynamic_label_matches(pad_harness):
    """Dynamic labels across X-PAD segments, including multi-segment text
    and repeated transmission, must match the compiled reference."""
    import tests.test_pad as tp
    fields = []
    for text in ("Now Playing - Golden Differential Radio",
                 "Short", "Another label 123 with more text here!"):
        for group in tp.label_data_groups(text):
            fields += tp.chunk_xpad_fields(group, 2, 3)
    ref = _run_pad_harness(pad_harness, fields)
    ours = _run_our_pad(fields)
    assert ours == ref


def test_pad_mot_slideshow_matches(pad_harness):
    """A MOT object (header + body segments) carried over X-PAD must
    reassemble identically (transport id, header fields, body bytes)."""
    import tests.test_pad as tp
    from tests.test_packets import build_mot_segment, build_mot_header
    from dab_radio_tpu.dab.mot import HEADER, UNSCRAMBLED_BODY
    rng = np.random.default_rng(12)
    body = rng.integers(0, 256, 300).astype(np.uint8).tobytes()
    tid = 0x77
    segs = [body[i:i + 96] for i in range(0, len(body), 96)]
    fields = []
    for rep in range(2):
        g = build_mot_segment(HEADER, 0, True, tid,
                              build_mot_header(body, "golden.bin"))
        fields += tp.chunk_xpad_fields(g, 12, 13,
                                       length_prefix=tp.dli_prefix(len(g)))
        for i, s in enumerate(segs):
            g = build_mot_segment(UNSCRAMBLED_BODY, i, i == len(segs) - 1,
                                  tid, s)
            fields += tp.chunk_xpad_fields(g, 12, 13,
                                           length_prefix=tp.dli_prefix(len(g)))
    ref = _run_pad_harness(pad_harness, fields)
    ours = _run_our_pad(fields)
    assert ours == ref


# ---------------- packet mode + RS packet FEC differential ----------------

@pytest.fixture(scope="module")
def pkt_harness():
    exe = "/tmp/dab_pkt_harness"
    srcs = [os.path.join(HERE, "golden", "packet_harness.cpp"),
            f"{REF}/dab/msc/msc_data_packet_processor.cpp",
            f"{REF}/dab/msc/msc_reed_solomon_data_packet_processor.cpp",
            f"{REF}/dab/msc/msc_data_group_processor.cpp",
            f"{REF}/dab/mot/MOT_processor.cpp",
            f"{REF}/dab/mot/MOT_assembler.cpp",
            f"{REF}/dab/constants/charsets.cpp",
            f"{REF}/dab/algorithms/reed_solomon_decoder.cpp"]
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{REF}",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe] + srcs,
                   check=True, capture_output=True)
    return exe


def _mot_event_lines(events_sink):
    def on_entity(e):
        name = (e.header.content_name.encode().hex()
                if e.header.content_name else "-")
        events_sink.append(
            f"mot {e.transport_id} {e.header.content_type} "
            f"{e.header.content_sub_type} {name} {bytes(e.body).hex()}")
    return on_entity


def test_packet_mode_matches_reference(pkt_harness):
    """Packet assembly -> data groups -> MOT must reassemble identically."""
    from tests.test_packets import make_mot_stream
    stream, _body = make_mot_stream(address=2, body_len=700)
    # packets are variable-size (24..96B): split only at packet boundaries
    chunks, i = [], 0
    from dab_radio_tpu.dab.packets import PACKET_LENGTH
    while i < len(stream):
        n = PACKET_LENGTH[(stream[i] >> 6) & 0b11]
        chunks.append(stream[i:i + n])
        i += n
    out = subprocess.run(
        [pkt_harness, "2"],
        input=("\n".join("K " + c.hex() for c in chunks) + "\n").encode(),
        capture_output=True, check=True, timeout=120).stdout.decode()
    ref = [l for l in out.splitlines() if l.startswith("mot ")]

    from dab_radio_tpu.dab.packets import PacketProcessor
    proc = PacketProcessor(2)
    ours = []
    proc.mot.on_entity.append(_mot_event_lines(ours))
    for c in chunks:
        proc.process(c)
    assert ours == ref and len(ref) >= 1


def test_packet_fec_matches_reference(pkt_harness):
    """RS(204,188) packet FEC: corrected packet stream and downstream MOT
    must match the compiled reference on a corrupted stream."""
    from tests.test_packets import make_mot_stream, _fec_frame
    from dab_radio_tpu.dab.packets import (PacketProcessor, APP_DATA_TABLE)
    stream, _body = make_mot_stream(address=2, body_len=900)
    pad_packet = bytearray(24)
    pad_packet[0] = (0 << 6) | (0b11 << 2) | ((1023 >> 8) & 0b11)
    pad_packet[1] = 1023 & 0xFF
    while len(stream) % APP_DATA_TABLE:
        stream += bytes(pad_packet)
    frames = [
        _fec_frame(stream[i:i + APP_DATA_TABLE], corrupt=6, seed=i)
        for i in range(0, len(stream), APP_DATA_TABLE)
    ]
    out = subprocess.run(
        [pkt_harness, "2"],
        input=("\n".join("R " + f.hex() for f in frames) + "\n").encode(),
        capture_output=True, check=True, timeout=120).stdout.decode()
    ref_mot = [l for l in out.splitlines() if l.startswith("mot ")]

    proc = PacketProcessor(2, use_fec=True)
    ours = []
    proc.mot.on_entity.append(_mot_event_lines(ours))
    for f in frames:
        proc.process(f)
    assert ours == ref_mot and len(ref_mot) >= 1


def test_aac_data_stream_element_matches(pad_harness):
    """PAD extraction from AAC data_stream_elements (the reverse-engineered
    libfaad syntax path) must match the compiled reference: dynamic labels
    carried inside access units decode identically."""
    import tests.test_pad as tp
    from dab_radio_tpu.dab.aac_data import (AACDataDecoder,
                                            build_data_stream_element)
    rng = np.random.default_rng(31)
    fields = []
    for text in ("DSE Golden Label", "Second text via access units!!"):
        for group in tp.label_data_groups(text):
            fields += tp.chunk_xpad_fields(group, 2, 3)
    aus = [build_data_stream_element(f, x)
           + rng.integers(0, 256, 20).astype(np.uint8).tobytes()
           for f, x in fields]

    stdin = "\n".join("A " + au.hex() for au in aus) + "\n"
    out = subprocess.run([pad_harness], input=stdin.encode(),
                         capture_output=True, check=True,
                         timeout=120).stdout.decode()
    ref = [l for l in out.splitlines() if not l.startswith("input ")]

    dec = AACDataDecoder()
    ours = []
    dec.pad.on_label.append(
        lambda label: ours.append(f"label |{label.encode().hex()}|"))
    for au in aus:
        dec.process_access_unit(au)
    assert ours == ref and len(ref) >= 2


# ---------------- FIC -> database differential ----------------

@pytest.fixture(scope="module")
def db_harness():
    exe = "/tmp/dab_db_harness"
    srcs = [os.path.join(HERE, "golden", "database_harness.cpp"),
            f"{REF}/dab/fic/fig_processor.cpp",
            f"{REF}/dab/radio_fig_handler.cpp",
            f"{REF}/dab/database/dab_database_updater.cpp",
            f"{REF}/dab/constants/charsets.cpp"]
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{REF}",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe] + srcs,
                   check=True, capture_output=True)
    return exe


def _dump_our_db(db) -> list:
    def hx(s):
        b = s.encode()
        return b.hex() if b else "-"
    out = []
    e = db.ensemble
    out.append(f"ens {e.id} {e.extended_country_code} {hx(e.label)} "
               f"{hx(e.short_label)} {e.nb_services} "
               f"{e.reconfiguration_count} {e.local_time_offset} "
               f"{e.international_table_id} {int(e.is_complete)}")
    for sid in sorted(db.services):
        s = db.services[sid]
        out.append(f"svc {sid} {hx(s.label)} {hx(s.short_label)} "
                   f"{s.programme_type} {int(s.is_complete)}")
    for c in sorted(db.service_components,
                    key=lambda c: (c.service_id, c.component_id)):
        gid = 0xFFFF if c.global_id is None else c.global_id
        sub = 0 if c.subchannel_id is None else c.subchannel_id
        addr = 0 if c.packet_address is None else c.packet_address
        tm = 255 if c.transport_mode is None else c.transport_mode
        ast = 255 if c.audio_service_type is None else c.audio_service_type
        dst = 255 if c.data_service_type is None else c.data_service_type
        apps = "".join(f" {t}" for t in c.user_app_types)
        out.append(f"comp {c.service_id} {c.component_id} {gid} {sub} "
                   f"{addr} {hx(c.label)} {c.language} {tm} {ast} {dst}"
                   f"{apps} {int(c.is_complete)}")
    for lsn in sorted(db.link_services):
        l = db.link_services[lsn]
        sid = l.service_ids[0] if l.service_ids else 0
        out.append(f"link {lsn} {int(l.is_active_link)} "
                   f"{int(l.is_hard_link)} {int(l.is_international)} {sid} "
                   f"{int(l.is_complete)}")
    for pi in sorted(db.fm_services):
        f = db.fm_services[pi]
        freqs = "".join(f" {q}" for q in f.frequencies)
        out.append(f"fm {pi} {f.lsn or 0} {int(f.is_time_compensated)}"
                   f"{freqs} {int(f.is_complete)}")
    for did in sorted(db.drm_services):
        d = db.drm_services[did]
        freqs = "".join(f" {q}" for q in d.frequencies)
        out.append(f"drm {did} {d.lsn or 0} {int(d.is_time_compensated)}"
                   f"{freqs} {int(d.is_complete)}")
    for eid in sorted(db.other_ensembles):
        o = db.other_ensembles[eid]
        out.append(f"oe {eid} {o.frequency_hz} {int(o.is_continuous)} "
                   f"{int(o.is_geo_adjacent)} {int(o.is_mode_one)} "
                   f"{int(o.is_complete)}")
    for sub_id in sorted(db.subchannels):
        s = db.subchannels[sub_id]
        start = 0 if s.start_address is None else s.start_address
        length = 0 if s.length is None else s.length
        uep = 0 if not s.is_uep else 1
        uidx = s.uep_table_index or 0
        eplev = s.eep_prot_level or 0
        etype = {None: 255, "A": 0, "B": 1}[s.eep_type]
        fec = 255 if s.fec_scheme is None else s.fec_scheme
        out.append(f"subch {sub_id} {start} {length} {uep} {uidx} {eplev} "
                   f"{etype} {fec} {int(s.is_complete)}")
    return out


def _misc_line(misc) -> str:
    from dab_radio_tpu.dab.mot import mjd_to_ymd
    y, m, d = mjd_to_ymd(misc.mjd) if misc.mjd else (0, 0, 0)
    return (f"misc {misc.cif_upper} {misc.cif_lower} {y} {m} {d} "
            f"{misc.hours} {misc.minutes} {misc.seconds} "
            f"{misc.milliseconds}")


def test_fic_database_matches_reference(db_harness):
    """The whole FIC chain — FIG parse -> handler -> database merge — must
    produce the same ensemble/service/component/subchannel state as the
    compiled reference for a complete mixed-service ensemble."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dab_radio_tpu.models.transmitter import EnsembleTransmitter, ServiceSpec
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.dab.fig import FIGParser
    from dab_radio_tpu.dab.database import DatabaseUpdater

    tx = EnsembleTransmitter(1, services=[
        ServiceSpec(0xA001, 1, "Svc AAC",
                    SubchannelConfig(0, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="dab+"),
        ServiceSpec(0xA002, 2, "Svc MP2",
                    SubchannelConfig(48, 42, True, uep_table_index=8),
                    kind="dab"),
        ServiceSpec(0xA003, 3, "Svc Data",
                    SubchannelConfig(132, 48, False, eep_type="A",
                                     eep_prot_level=2), kind="packet",
                    scid=0x10, packet_address=2),
    ])
    fibs = []
    for _ in range(6):      # several carousel rounds
        fibs += [bytes(tx.fic_encoder.encode_fib_payload(p))[:30]
                 for p in tx._fib_payloads()]
        tx._cif_counter += 4

    # extra FIGs covering links, frequency info, other ensembles, datetime
    def fig(t, body):
        return bytes([(t << 5) | len(body)]) + bytes(body)

    def fib_of(*figs):
        return (b"".join(figs) + b"\xff" + b"\x00" * 29)[:30]

    enc = tx.fic_encoder
    extra_payloads = [
        # 0/6: DAB sid link + RDS link (non-intl 16-bit)
        fig(0, [0x06, 0x80 | 0x01, 0x11, 0x00 | 0x01, 0xA0, 0x01])
        + fig(0, [0x06, 0x80 | 0x01, 0x11, 0x20 | 0x02,
                  0xAB, 0xCD, 0x12, 0x34]),
        # 0/6: DRM link
        fig(0, [0x06, 0x80 | 0x02, 0x22, 0x60 | 0x01, 0x00, 0x01, 0x02, 0x03]),
        # 0/21: rm=0 other-ensemble freq + rm=8 FM freqs
        fig(0, [0x15, 0x00, 0x06, 0xC1, 0x85, 0x03, 0x06, 0x1A, 0xB0])
        + fig(0, [0x15, 0x00, 0x05, 0xAB, 0xCD, 0x82, 0x30, 0x55]),
        # 0/24: other ensemble services
        fig(0, [0x18, 0xB0, 0x01, 0x01, 0xC1, 0x85]),
        # 0/10: long-form datetime
        fig(0, [0x0A, 0x3A, 0x5B, 0x2F, 0x45, 0x8F, 0x12]),
    ]
    fibs += [bytes(enc.encode_fib_payload(p))[:30] for p in extra_payloads]

    out = subprocess.run(
        [db_harness], input=("\n".join(f.hex() for f in fibs) + "\n").encode(),
        capture_output=True, check=True, timeout=120).stdout.decode()

    def norm(line):
        # documented divergence: we rstrip the 16-char label padding at the
        # parser; the reference stores labels verbatim
        parts = line.split()
        idxs = {"ens": (3, 4), "svc": (2, 3), "comp": (6,)}.get(parts[0], ())
        for i in idxs:
            if parts[i] != "-":
                t = bytes.fromhex(parts[i]).decode("latin-1").rstrip()
                parts[i] = t.encode("latin-1").hex() or "-"
        return " ".join(parts)

    ref = [norm(l) for l in out.strip().splitlines()]

    parser = FIGParser()
    upd = DatabaseUpdater()
    for fib in fibs:
        for ev in parser.parse_fib(fib):
            upd.apply(ev)
    ours = [norm(l) for l in _dump_our_db(upd.db)] \
        + [_misc_line(upd.misc)]
    ref = ref + []
    assert sorted(ours) == sorted(ref), "\n" + "\n".join(
        f"ref : {r}\nours: {o}" for r, o in zip(ref, ours) if r != o)


def test_fig_labels_charsets_match(fig_harness):
    """Labels in UCS-2, UTF-8 and ISO 8859-1 charsets decode identically to
    the compiled reference's charset conversion."""
    def fig1_label(ext, idbytes, label_bytes, charset):
        body = bytes([(charset << 4) | ext]) + idbytes \
            + label_bytes.ljust(16)[:16] + bytes([0xFF, 0x00])
        return bytes([(1 << 5) | len(body)]) + body

    cases = [
        (6, "Ünïcödé".encode("utf-16-be")),          # UCS-2 BE
        (15, "utf8 ✓ label".encode("utf-8")),        # UTF-8
        (4, "látin-1 tëxt".encode("latin-1")),       # ISO 8859-1
        (0, b"EBU \x86\x8b plain"),                  # EBU with accents
    ]
    fibs = []
    for cs, lab in cases:
        fib = fig1_label(1, b"\xa0\x05", lab, cs)
        fibs.append((fib + b"\xff" * 30)[:30])

    ref = _run_fig_harness(fig_harness, fibs)
    from dab_radio_tpu.dab.fig import FIGParser
    parser = FIGParser()
    for i, fib in enumerate(fibs):
        ours = []
        for ev in parser.parse_fib(fib):
            ours.extend(_translate(ev))
        ours = [_norm_ref_line(x) for x in ours]
        assert ours == ref[i], (i, fib.hex(), ref[i], ours)


def test_pad_label_command_matches(pad_harness):
    """Dynamic-label command data group (clear display) must emit the same
    command event in both decoders."""
    import tests.test_pad as tp
    from dab_radio_tpu.ops.crc import crc16
    from dab_radio_tpu.dab.pad import PADProcessor
    # command group: C flag set (bit 4), command 0
    b0 = (1 << 7) | (0b11 << 5) | (1 << 4) | 0
    g = bytes([b0, 0x00])
    g += crc16(g).to_bytes(2, "big")
    fields = tp.chunk_xpad_fields(g, 2, 3)
    # follow with a normal label to prove the stream stays in sync
    for group in tp.label_data_groups("After Command"):
        fields += tp.chunk_xpad_fields(group, 2, 3)

    ref = _run_pad_harness(pad_harness, fields)
    pad = PADProcessor()
    ours = []
    pad.on_label.append(
        lambda label: ours.append(f"label |{label.encode().hex()}|"))
    pad.dynamic_label.on_command.append(
        lambda cmd: ours.append(f"label_cmd {cmd}"))
    for f, x in fields:
        pad.process(f, x)
    assert ours == ref and any(l.startswith("label_cmd") for l in ref)


# ---------------- IQ format readers differential ----------------

@pytest.fixture(scope="module")
def iq_harness():
    exe = "/tmp/dab_iq_harness"
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{REF}",
                    f"-I{os.path.dirname(REF)}/examples",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe,
                    os.path.join(HERE, "golden", "iq_harness.cpp")],
                   check=True, capture_output=True)
    return exe


_IQ_MODE_MAP = {
    "u8": "raw_u8", "s8": "raw_s8",
    "u16le": "raw_u16l", "u16be": "raw_u16b",
    "s16le": "raw_s16l", "s16be": "raw_s16b",
    "u32le": "raw_u32l", "u32be": "raw_u32b",
    "s32le": "raw_s32l", "s32be": "raw_s32b",
    "f32le": "raw_f32l", "f32be": "raw_f32b",
    "f64le": "raw_f64l", "f64be": "raw_f64b",
}


def test_iq_readers_match_reference(iq_harness):
    """All 14 raw IQ sample formats must dequantize exactly like the
    reference readers (bias/scale per QuantisedIQ<T>, endianness swaps)."""
    from dab_radio_tpu.host.native import iq_convert
    rng = np.random.default_rng(99)
    lines = []
    raws = {}
    for fmt, mode in _IQ_MODE_MAP.items():
        if fmt.startswith("f"):
            vals = rng.normal(0, 0.7, 64).astype(
                np.float32 if "32" in fmt else np.float64)
            raw = vals.astype(
                ("<" if fmt.endswith("le") else ">")
                + ("f4" if "32" in fmt else "f8")).tobytes()
        else:
            nbytes = 64 * (1 if "8" in fmt and "1" not in fmt else
                           2 if "16" in fmt else 4)
            raw = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
        raws[fmt] = raw
        lines.append(f"{mode} {raw.hex()}")

    out = subprocess.run([iq_harness],
                         input=("\n".join(lines) + "\n").encode(),
                         capture_output=True, check=True,
                         timeout=120).stdout.decode()
    ref_lines = [l for l in out.splitlines() if l.startswith("samples")]
    assert len(ref_lines) == len(_IQ_MODE_MAP)

    for (fmt, _), rline in zip(_IQ_MODE_MAP.items(), ref_lines):
        vals = np.array([float(x) for x in rline.split()[1:]],
                        dtype=np.float32)
        ref = vals[0::2] + 1j * vals[1::2]
        ours = iq_convert(raws[fmt], fmt)
        assert ours.shape[0] == ref.shape[0], fmt
        np.testing.assert_allclose(ours.real, ref.real, rtol=2e-6,
                                   atol=1e-9, err_msg=fmt)
        np.testing.assert_allclose(ours.imag, ref.imag, rtol=2e-6,
                                   atol=1e-9, err_msg=fmt)


# ---------------------------------------------------------------------------
# label tables (TS 101 756): full-table equality with the reference headers
# ---------------------------------------------------------------------------

def test_language_table_matches_reference():
    import re
    from dab_radio_tpu.params.tables import LANGUAGES
    txt = open(f"{REF}/dab/constants/language_table.h").read()
    ref = {int(m.group(1), 16): m.group(2) for m in re.finditer(
        r'\{\s*0x([0-9A-Fa-f]+),\s*"([^"]*)"\s*\}', txt)}
    assert LANGUAGES == ref


def test_country_table_matches_reference():
    import re
    from dab_radio_tpu.params.tables import COUNTRIES
    txt = open(f"{REF}/dab/constants/country_table.h").read()
    ref = {}
    for m in re.finditer(
            r'\{\s*CODE\(0x([0-9A-Fa-f]+),\s*0x([0-9A-Fa-f]+)\),'
            r'\s*"([^"]*)"\s*\}', txt):
        key = (int(m.group(1), 16), int(m.group(2), 16))
        ref.setdefault(key, m.group(3))   # unordered_map: first entry wins
    assert COUNTRIES == ref


def test_programme_type_tables_match_reference():
    import re
    from dab_radio_tpu.params.tables import (PROGRAMME_TYPES_EU,
                                             PROGRAMME_TYPES_NA)
    txt = open(f"{REF}/dab/constants/programme_type_table.h").read()
    for name, ours in (("DAB_PROGRAMME_TYPE_TABLE_0", PROGRAMME_TYPES_EU),
                       ("DAB_PROGRAMME_TYPE_TABLE_1", PROGRAMME_TYPES_NA)):
        m = re.search(name + r' = std::vector<DAB_Programme_Label>\{(.*?)\};',
                      txt, re.S)
        ref = re.findall(r'\{\s*"([^"]*)",\s*"([^"]*)"\s*\}', m.group(1))
        assert [tuple(p) for p in ours] == ref, name


# ---------------------------------------------------------------------------
# OFDM demodulator differential: the reference's FULL OFDM_Demod compiled
# in place against the fftw3.h shim (tests/golden/fftw3.h — the one vendor
# dependency this image lacks), driven over the same IQ streams as our
# demodulator. Closes the demod half of BASELINE.md's "frame-exact
# agreement" north star; the digital decode layers already had compiled-
# reference oracles.
# ---------------------------------------------------------------------------

def build_demod_harness() -> str:
    """Compile the reference OFDM demod harness; plain function so
    tools/compare_with_reference.py can reuse it outside pytest."""
    exe = "/tmp/dab_ofdm_demod_harness"
    srcs = [os.path.join(HERE, "golden", "ofdm_demod_harness.cpp")] + [
        f"{REF}/ofdm/{f}" for f in (
            "ofdm_demodulator.cpp", "ofdm_demodulator_threads.cpp",
            "dab_ofdm_params_ref.cpp", "dab_prs_ref.cpp",
            "dab_mapper_ref.cpp", "dsp/apply_pll.cpp",
            "dsp/complex_conj_mul_sum.cpp")]
    subprocess.run(["g++", "-O2", "-std=c++17", "-DNDEBUG", "-pthread",
                    f"-I{REF}", f"-I{os.path.join(HERE, 'golden')}",
                    "-o", exe] + srcs, check=True, capture_output=True)
    return exe


@pytest.fixture(scope="module")
def demod_harness():
    return build_demod_harness()


def _run_ref_demod(exe, sig: np.ndarray, mode: int) -> np.ndarray:
    """Reference demod over a complex64 stream -> (F, nb_frame_bits) int8."""
    from dab_radio_tpu.params import get_ofdm_params
    p = get_ofdm_params(mode)
    nb_bits = (p.nb_frame_symbols - 1) * p.nb_data_carriers * 2
    r = subprocess.run([exe, str(mode), "1"],
                       input=sig.astype(np.complex64).tobytes(),
                       capture_output=True, timeout=300, check=True)
    bits = np.frombuffer(r.stdout, dtype=np.int8)
    return bits[: bits.shape[0] // nb_bits * nb_bits].reshape(-1, nb_bits)


def _our_demod_frames(sig: np.ndarray, mode: int):
    from dab_radio_tpu.models.demodulator import (OFDMDemodulator,
                                                  StreamingDemodulator)
    sd = StreamingDemodulator(OFDMDemodulator(mode))
    return [np.asarray(b) for b in sd.process(sig)]


def _best_aligned_agreement(ref, ours):
    """Hard-bit agreement per frame at the best ref/our frame offset
    (acquisition may start one frame apart)."""
    best = None
    for off in range(-2, 3):
        pairs = [(ref[k + off] > 0, ours[k] > 0)
                 for k in range(len(ours))
                 if 0 <= k + off < ref.shape[0]]
        if not pairs:
            continue
        agree = [float((a == b).mean()) for a, b in pairs]
        score = sum(agree) / len(agree)
        if best is None or score > best[0]:
            best = (score, agree)
    return best[1]


def _ensemble_sig(nb_frames: int, seed: int, lead: int = 3000):
    """Synthetic 2-service DAB+ ensemble (real tone audio) + noise lead."""
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.params import SubchannelConfig
    rng = np.random.default_rng(seed)
    tx = EnsembleTransmitter(transmission_mode=1, services=[
        ServiceSpec(0xF123 + i, 3 + i, f"Radio DAB {i + 1}",
                    SubchannelConfig(48 * i, 48, False, eep_type="A",
                                     eep_prot_level=2))
        for i in range(2)])
    tx.enable_tone_audio()
    head = (rng.normal(0, 0.005, lead)
            + 1j * rng.normal(0, 0.005, lead)).astype(np.complex64)
    return np.concatenate([head, tx.generate(nb_frames)])


@pytest.mark.slow
def test_reference_ofdm_demod_bit_exact_clean(demod_harness):
    """Clean synthetic ensemble: every locked frame's hard-decision bits
    from the compiled reference demodulator equal ours exactly."""
    sig = _ensemble_sig(10, seed=0)

    ref = _run_ref_demod(demod_harness, sig, 1)
    ours = _our_demod_frames(sig, 1)
    assert len(ours) >= 8 and ref.shape[0] >= 8
    agree = _best_aligned_agreement(ref, ours)
    assert all(a == 1.0 for a in agree), agree


def _decode_aus(frames):
    """Soft-bit frames -> (receiver, [(sub, au_bytes)]) via our decode."""
    from dab_radio_tpu.models.receiver import DabReceiver
    rx = DabReceiver(1, benchmark_all=True)
    aus = []
    rx.on_audio_channel.append(
        lambda sub, ch: ch.events.on_access_unit.append(
            lambda i, n, au, hdr: aus.append((sub, bytes(au)))))
    for f in frames:
        rx.process_frame(np.asarray(f, dtype=np.int8))
    return rx, aus


@pytest.mark.slow
def test_reference_ofdm_demod_agrees_under_cfo_and_noise(demod_harness):
    """A 1.7 kHz CFO + AWGN: both demodulators lock without desync and
    track the same signal. Their residual fine-CFO tracking differs
    (the reference applies damped corrections one frame late; ours
    corrects same-frame), so a few percent of hard bits flip from
    inter-carrier interference on whichever stream carries the larger
    residual — the equivalence that matters is that BOTH soft streams
    decode to the IDENTICAL access-unit stream through the digital chain
    (Viterbi absorbs the ICI-marginal bits)."""
    rng = np.random.default_rng(1)
    sig = _ensemble_sig(16, seed=1, lead=5000)
    n = np.arange(sig.shape[0])
    sig = sig * np.exp(2j * np.pi * (1700.0 / 2.048e6) * n)
    sig = (sig + rng.normal(0, 0.02, sig.shape)
           + 1j * rng.normal(0, 0.02, sig.shape)).astype(np.complex64)

    ref = _run_ref_demod(demod_harness, sig, 1)
    ours = _our_demod_frames(sig, 1)
    assert len(ours) >= 13 and ref.shape[0] >= 13
    agree = _best_aligned_agreement(ref, ours)
    locked = agree[2:]                       # allow reference settle frames
    assert all(a >= 0.95 for a in locked), agree

    _, aus_ref = _decode_aus(list(ref))
    _, aus_our = _decode_aus(ours)
    assert len(aus_ref) > 0 and len(aus_our) > 0
    m = min(len(aus_ref), len(aus_our))
    assert aus_ref[:m] == aus_our[:m] or aus_ref[-m:] == aus_our[-m:]


@pytest.mark.slow
def test_reference_ofdm_demod_agrees_under_sfn_echo(demod_harness):
    """In-guard SFN echo (100 us, -3 dB, rotated) + receiver noise: both
    demodulators must lock through the two-peak matched-filter response
    (reference src/ofdm/ofdm_demodulator.cpp:473-548) and track the same
    signal. Fine-time sync may settle a few samples apart between the two
    implementations — DQPSK makes a static in-guard timing offset nearly
    bit-transparent — so the pinned equivalence is high hard-bit agreement
    plus an IDENTICAL access-unit stream through the digital chain."""
    from dab_radio_tpu.models.channel import ChannelModel, EchoTap
    sig = _ensemble_sig(16, seed=3, lead=5000)
    sig = ChannelModel(taps=[EchoTap(delay_us=100.0, gain_db=-3.0,
                                     phase_deg=40.0)],
                       snr_db=30.0, seed=3).apply(sig)

    ref = _run_ref_demod(demod_harness, sig, 1)
    ours = _our_demod_frames(sig, 1)
    assert len(ours) >= 13 and ref.shape[0] >= 13
    agree = _best_aligned_agreement(ref, ours)
    locked = agree[2:]                       # allow reference settle frames
    assert all(a >= 0.95 for a in locked), agree

    _, aus_ref = _decode_aus(list(ref))
    _, aus_our = _decode_aus(ours)
    assert len(aus_ref) > 0 and len(aus_our) > 0
    m = min(len(aus_ref), len(aus_our))
    assert aus_ref[:m] == aus_our[:m] or aus_ref[-m:] == aus_our[-m:]


@pytest.mark.slow
def test_reference_ofdm_demod_soft_bits_decode_in_our_receiver(demod_harness):
    """The decisive cross-check: the reference demodulator's soft bits fed
    into OUR digital decode chain produce the same ensemble database and
    the same access units as our own demod+decode — the two
    implementations are interchangeable at the frame interface."""
    sig = _ensemble_sig(16, seed=2)

    ref = _run_ref_demod(demod_harness, sig, 1)
    ours = _our_demod_frames(sig, 1)

    rx_ref, aus_ref = _decode_aus(list(ref))
    rx_our, aus_our = _decode_aus(ours)
    assert rx_ref.db.ensemble.id == rx_our.db.ensemble.id
    assert sorted(rx_ref.db.services) == sorted(rx_our.db.services)
    assert len(aus_ref) > 0
    # frame alignment may differ by one frame at the edges: the common
    # AU stream must be identical
    m = min(len(aus_ref), len(aus_our))
    assert m >= len(aus_ref) - 8
    assert aus_ref[:m] == aus_our[:m] or aus_ref[-m:] == aus_our[-m:]


@pytest.mark.slow
@pytest.mark.parametrize("mode", [2, 4])
def test_reference_ofdm_demod_bit_exact_other_modes(demod_harness, mode):
    """Transmission modes II/IV (smaller FFTs, different frame geometry):
    random-payload modulator output demodulates to identical hard bits in
    the compiled reference and here. (Mode III FIC is rejected by both
    decoders, but its demod geometry is covered by the mode-II/IV pair:
    512/1024-point FFTs bracket mode III's 256.)"""
    from dab_radio_tpu.models import OFDMModulator
    from dab_radio_tpu.params import get_ofdm_params
    import jax.numpy as jnp
    rng = np.random.default_rng(mode)
    mod = OFDMModulator(mode)
    p = get_ofdm_params(mode)
    bits = rng.integers(0, 2, (12, p.nb_data_symbols,
                               2 * p.nb_data_carriers)).astype(np.uint8)
    iq = np.asarray(mod.modulate_stream(jnp.asarray(bits)))
    lead = (rng.normal(0, 0.005, 2000)
            + 1j * rng.normal(0, 0.005, 2000)).astype(np.complex64)
    sig = np.concatenate([lead, iq])

    ref = _run_ref_demod(demod_harness, sig, mode)
    ours = _our_demod_frames(sig, mode)
    assert len(ours) >= 10 and ref.shape[0] >= 10
    agree = _best_aligned_agreement(ref, ours)
    assert all(a == 1.0 for a in agree), agree


@pytest.mark.slow
def test_reference_ofdm_demod_asan_clean():
    """The demod harness (reference OFDM_Demod + our fftw3 shim) under
    AddressSanitizer on a clean ensemble: no OOB in the shim's buffer
    contract (same ASan-oracle pattern as the FIG harness)."""
    exe = "/tmp/dab_ofdm_demod_harness_asan"
    srcs = [os.path.join(HERE, "golden", "ofdm_demod_harness.cpp")] + [
        f"{REF}/ofdm/{f}" for f in (
            "ofdm_demodulator.cpp", "ofdm_demodulator_threads.cpp",
            "dab_ofdm_params_ref.cpp", "dab_prs_ref.cpp",
            "dab_mapper_ref.cpp", "dsp/apply_pll.cpp",
            "dsp/complex_conj_mul_sum.cpp")]
    subprocess.run(["g++", "-O1", "-g", "-fsanitize=address", "-std=c++17",
                    "-DNDEBUG", "-pthread", f"-I{REF}",
                    f"-I{os.path.join(HERE, 'golden')}", "-o", exe] + srcs,
                   check=True, capture_output=True)
    sig = _ensemble_sig(6, seed=3)
    r = subprocess.run([exe, "1", "1"],
                       input=sig.astype(np.complex64).tobytes(),
                       capture_output=True, timeout=280)
    err = r.stderr.decode()
    assert r.returncode == 0 and "ERROR" not in err, err[-800:]
    # the harness runs the reference's threaded pipeline; under ASan on a
    # loaded machine it can drop a trailing frame — the oracle here is
    # ASan cleanliness, so only require that it locked and decoded most
    m = re.search(r"frames=(\d+)", err)
    assert m and int(m.group(1)) >= 4, err


@pytest.mark.slow
def test_reference_ofdm_demod_mode3_divergence(demod_harness):
    """Documented divergence, found BY the demod differential: the
    reference cannot demodulate transmission mode III at all.

    On a mode-III signal whose every constant is golden-verified against
    the reference's own tables (params/PRS/carrier map; the modulator is
    mode-generic and the reference demodulates its mode I/II/IV output
    with 100% hard-bit agreement):

      - stock config: permanent desync — the 192-carrier/256-point PRS
        impulse peak sits below the 20 dB fine-time gate
        (ofdm_demodulator.h:42), so no frame is ever emitted;
      - with the gate lowered (the knob its GUI exposes): it "locks" but
        emits wrong-timing garbage (~55-68% agreement vs the transmitted
        bits at any threshold — chance-level demodulation);
      - our demodulator decodes the same stream bit-exactly with no
        tuning.

    Mode III was designed for satellite delivery and never broadcast
    terrestrially; with no real captures the upstream had no way to see
    this latent defect. Kept as a pinned divergence, not parity."""
    from dab_radio_tpu.models import OFDMModulator
    from dab_radio_tpu.params import get_ofdm_params
    import jax.numpy as jnp
    mode = 3
    rng = np.random.default_rng(3)
    mod = OFDMModulator(mode)
    p = get_ofdm_params(mode)
    bits = rng.integers(0, 2, (14, p.nb_data_symbols,
                               2 * p.nb_data_carriers)).astype(np.uint8)
    iq = np.asarray(mod.modulate_stream(jnp.asarray(bits)))
    lead = (rng.normal(0, 0.005, 2000)
            + 1j * rng.normal(0, 0.005, 2000)).astype(np.complex64)
    sig = np.concatenate([lead, iq])
    nb = (p.nb_frame_symbols - 1) * p.nb_data_carriers * 2

    # stock config: permanent desync, zero frames
    r = subprocess.run([demod_harness, "3", "1"],
                       input=sig.astype(np.complex64).tobytes(),
                       capture_output=True, timeout=300, check=True)
    assert len(r.stdout) == 0 and b"desync=" in r.stderr, r.stderr

    # lowered gate: emits frames, but they never decode the TX bits
    r = subprocess.run([demod_harness, "3", "1", "5"],
                       input=sig.astype(np.complex64).tobytes(),
                       capture_output=True, timeout=300, check=True)
    ref = np.frombuffer(r.stdout, dtype=np.int8)
    ref = ref[: ref.shape[0] // nb * nb].reshape(-1, nb)
    assert ref.shape[0] >= 10
    best = 0.0
    for off in range(-3, 4):
        ag = [float(((ref[k] > 0)
                     == bits[k + off].reshape(-1).astype(bool)).mean())
              for k in range(ref.shape[0]) if 0 <= k + off < bits.shape[0]]
        if ag:
            best = max(best, sum(ag) / len(ag))
    assert best < 0.9, f"reference unexpectedly decodes mode III: {best}"

    # ours: bit-exact closed loop, no tuning (acquisition may consume a
    # couple of leading frames in mode III — align the first lock like
    # test_roundtrip_clean does)
    ours = _our_demod_frames(sig, mode)
    assert len(ours) >= 10
    h0 = (np.asarray(ours[0]) > 0).astype(np.uint8)
    ag = [float((h0 == tx.reshape(-1)).mean()) for tx in bits]
    k0 = int(np.argmax(ag))
    assert ag[k0] == 1.0, f"no tx frame matches the first lock: {ag}"
    for k in range(min(8, len(ours), bits.shape[0] - k0)):
        np.testing.assert_array_equal(
            (np.asarray(ours[k]) > 0).astype(np.uint8),
            bits[k0 + k].reshape(-1))


@pytest.mark.slow
def test_reference_ofdm_demod_sample_slip_parity(demod_harness):
    """Robustness differential: a mid-stream sample-clock slip (150
    duplicated samples ~ a real SDR clock hiccup) is absorbed by BOTH
    demodulators — every transmitted frame decodes, bit-identical between
    the two. A slip beyond the cyclic prefix (600 samples) costs at most
    a couple of frames around the event on either side, and the frames
    both decode afterwards are again identical."""
    base = _ensemble_sig(16, seed=5)
    clean = _our_demod_frames(base, 1)
    assert len(clean) >= 14

    def ids(frames):
        out = []
        for f in frames:
            h = np.asarray(f) > 0
            m = [k for k, c in enumerate(clean)
                 if np.array_equal(h, np.asarray(c) > 0)]
            out.append(m[0] if m else None)
        return out

    for slip_len, max_lost in ((150, 0), (600, 3)):
        cut = 3000 + 8 * 196608
        slip = np.concatenate([base[:cut], base[cut - slip_len:cut],
                               base[cut:]])
        ref_ids = ids(list(_run_ref_demod(demod_harness, slip, 1)))
        our_ids = ids(_our_demod_frames(slip, 1))
        ref_ok = [i for i in ref_ids if i is not None]
        our_ok = [i for i in our_ids if i is not None]
        # both decode (nearly) every transmitted frame, as the same bits
        assert len(set(our_ok)) >= len(clean) - 1 - max_lost, \
            (slip_len, our_ids)
        assert len(set(ref_ok)) >= len(clean) - 1 - max_lost, \
            (slip_len, ref_ids)
        # frames decoded by both are the identical set modulo the lost
        # window: compare the shared suffix after the slip
        assert set(our_ok) & set(ref_ok) >= set(range(10, len(clean) - 1)), \
            (slip_len, ref_ids, our_ids)
