"""Real-capture differential harness against the compiled C++ reference.

Given an IQ capture (or the synthetic transmitter's output), decodes it
with this framework and cross-checks the digital decode, event for event,
against the reference's OWN compiled code — the same read-only
#include-in-place harnesses the golden unit tests build
(tests/golden/fig_harness.cpp, superframe_harness.cpp):

  - every CRC-valid FIB       -> reference FIG_Processor events
                                  vs our FIG parser's events
  - every DAB+ subchannel's
    MSC logical frames        -> reference AAC_Frame_Processor
                                  header/AU/error events vs our
                                  SuperframeProcessor

This is the "given a capture, compare against the reference binary"
harness, ready for when real IQ captures
exist (the reference README's released captures are not fetchable
offline). With --demod the capture ALSO runs through the reference's own
compiled OFDM demodulator (tests/golden/ofdm_demod_harness.cpp against
the fftw3.h shim) and the per-frame hard bits are diffed against ours.
The reference Viterbi still cannot compile (the ViterbiDecoderCpp
submodule is absent from the snapshot); that layer is covered by the
closed-loop TX->RX bit-exactness tests.

Usage:
  python tools/compare_with_reference.py -i capture.u8 -F u8 \
      [--max-frames N] [-M mode] [--demod] [--backend cpu]
Exit code 0 = every event matched; 1 = mismatches (printed).
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def _compile_harnesses():
    import tests.test_golden_reference as G
    ref = G.REF
    golden = os.path.join(ROOT, "tests", "golden")
    fig_exe = "/tmp/dab_capture_fig_harness"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{ref}", f"-I{golden}",
         "-o", fig_exe, os.path.join(golden, "fig_harness.cpp"),
         f"{ref}/dab/fic/fig_processor.cpp",
         f"{ref}/dab/constants/charsets.cpp"],
        check=True, capture_output=True)
    sf_exe = "/tmp/dab_capture_sf_harness"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-DNDEBUG", f"-I{ref}", f"-I{golden}",
         "-o", sf_exe, os.path.join(golden, "superframe_harness.cpp"),
         f"{ref}/dab/audio/aac_frame_processor.cpp",
         f"{ref}/dab/msc/cif_deinterleaver.cpp",
         f"{ref}/dab/algorithms/reed_solomon_decoder.cpp"],
        check=True, capture_output=True)
    return fig_exe, sf_exe


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-F", "--format", default="u8")
    ap.add_argument("-M", "--transmission-mode", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("-b", "--block-size", type=int, default=65536 * 4)
    ap.add_argument("--demod", action="store_true",
                    help="also run the capture through the reference's "
                         "compiled OFDM demodulator and diff hard bits")
    args, rest = ap.parse_known_args(argv)
    sys.argv = [sys.argv[0]] + rest
    from dab_radio_tpu.utils.backend import add_backend_flag, apply_backend
    ap2 = argparse.ArgumentParser()
    add_backend_flag(ap2)
    apply_backend(ap2.parse_args(rest))

    from dab_radio_tpu.host.native import iq_convert
    from dab_radio_tpu.host.io import IQReader
    from dab_radio_tpu.models.demodulator import (OFDMDemodulator,
                                                  StreamingDemodulator)
    from dab_radio_tpu.models.receiver import DabReceiver

    # ---- decode the capture, recording FIBs + MSC logical frames --------
    fin = open(args.input, "rb")
    reader = IQReader(fin, args.format)
    demod = OFDMDemodulator(args.transmission_mode)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(args.transmission_mode, benchmark_all=True)

    fibs_all = []
    payloads = {}

    def on_channel(sub_id, ch):
        payloads.setdefault(sub_id, [])
        if hasattr(ch, "events"):
            ch.events.on_frame_data.append(
                lambda p, _s=sub_id: payloads[_s].append(bytes(p)))
    rx.on_audio_channel.append(on_channel)
    rx.on_data_channel.append(on_channel)
    orig_ingest = rx.ingest_fibs

    def ingest(fibs):
        fibs_all.extend(bytes(f) for f in fibs)
        return orig_ingest(fibs)
    rx.ingest_fibs = ingest

    import numpy as _np
    nb_frames = 0
    demod_frames = []
    while not args.max_frames or nb_frames < args.max_frames:
        raw = fin.read(args.block_size)
        if not raw:
            break
        for bits in sd.process(iq_convert(raw, reader.fmt)):
            rx.process_frame(bits)
            if args.demod:
                demod_frames.append(_np.asarray(bits))
            nb_frames += 1
            if args.max_frames and nb_frames >= args.max_frames:
                break
    print(f"# decoded {nb_frames} frames: {len(fibs_all)} CRC-valid FIBs, "
          f"{len(payloads)} subchannels "
          f"({ {k: len(v) for k, v in payloads.items()} })", file=sys.stderr)
    if not fibs_all:
        print("no FIBs decoded — nothing to compare", file=sys.stderr)
        return 1

    # ---- differentials vs the compiled reference ------------------------
    import tests.test_golden_reference as G
    fig_exe, sf_exe = _compile_harnesses()
    mismatches = 0

    if args.demod:
        # reference demod over the same capture; hard-bit per-frame diff
        # (our frames were collected in the main decode loop — no second
        # demod pass)
        import numpy as np
        from dab_radio_tpu.host.native import IQ_FORMATS, _FORMAT_ITEMSIZE
        bps = 2 * _FORMAT_ITEMSIZE[IQ_FORMATS[reader.fmt]]
        fin.seek(reader.data_offset)
        raw = fin.read() if not args.max_frames else fin.read(
            (args.max_frames + 2) * demod.params.nb_frame_samples * bps)
        sig = iq_convert(raw, reader.fmt)
        ours_frames = demod_frames
        exe = G.build_demod_harness()
        ref_frames = G._run_ref_demod(exe, sig, args.transmission_mode)
        agree = G._best_aligned_agreement(ref_frames, ours_frames) \
            if len(ours_frames) and ref_frames.shape[0] else []
        print(f"# demod differential: ref {ref_frames.shape[0]} frames, "
              f"ours {len(ours_frames)}; per-frame hard-bit agreement "
              f"min={min(agree):.6f} mean={sum(agree)/len(agree):.6f}"
              if agree else "# demod differential: no frames",
              file=sys.stderr)
        if not agree or min(agree) < 0.95:
            mismatches += 1
            print("demod mismatch: agreement below 0.95", file=sys.stderr)

    # FIG events
    from dab_radio_tpu.dab.fig import FIGParser
    ref_events = G._run_fig_harness(fig_exe, fibs_all)
    parser = FIGParser()
    n_events = 0
    for i, fib in enumerate(fibs_all):
        ours = []
        for ev in parser.parse_fib(fib):
            ours.extend(G._translate(ev))
        ours = [G._norm_ref_line(x) for x in ours]
        n_events += len(ours)
        if ours != ref_events[i]:
            mismatches += 1
            if mismatches <= 5:
                print(f"FIG mismatch on FIB {i} ({fib.hex()}):\n"
                      f"  ref : {ref_events[i]}\n  ours: {ours}",
                      file=sys.stderr)
    print(f"# FIG differential: {len(fibs_all)} FIBs, {n_events} events",
          file=sys.stderr)

    # superframe/AU events per DAB+ subchannel
    from dab_radio_tpu.dab.aac import SuperframeProcessor
    n_aus = 0
    for sub_id, frames in sorted(payloads.items()):
        if not frames:
            continue
        ref = G._run_sf_harness(sf_exe, [("F", f) for f in frames])
        proc = SuperframeProcessor()
        ours_flat = []
        for f in frames:
            res = proc.process_frame(f)
            if res is not None:
                h, aus = res
                ours_flat.append(
                    f"header {h.sampling_rate} {int(h.ps)} {int(h.sbr)} "
                    f"{int(h.is_stereo)} {h.mpeg_surround}")
                for k, au in enumerate(aus):
                    ours_flat.append(f"au {k} {len(aus)} "
                                     + " ".join(str(b) for b in au))
                    n_aus += 1
        ref_flat = [ln for evs in ref for ln in evs
                    if ln.startswith(("header", "au "))]
        if ours_flat != ref_flat:
            mismatches += 1
            print(f"superframe mismatch on subchannel {sub_id}: "
                  f"{len(ref_flat)} ref vs {len(ours_flat)} our events",
                  file=sys.stderr)
    print(f"# superframe differential: "
          f"{sum(len(v) for v in payloads.values())} logical frames, "
          f"{n_aus} AUs byte-identical" if not mismatches else "",
          file=sys.stderr)

    if mismatches:
        print(f"FAIL: {mismatches} mismatching units", file=sys.stderr)
        return 1
    print("OK: all FIG events and superframe AUs match the compiled "
          "reference", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
