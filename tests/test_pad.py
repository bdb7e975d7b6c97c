"""PAD closed loop: build X-PAD fields carrying a dynamic label and a MOT
slideshow, route through PADProcessor, verify label text and slideshow
reconstruction (incl. AAC data_stream_element extraction)."""

import numpy as np
import pytest

from dab_radio_tpu.dab.pad import PADProcessor
from dab_radio_tpu.dab.aac_data import AACDataDecoder, build_data_stream_element
from dab_radio_tpu.dab.slideshow import SlideshowManager
from dab_radio_tpu.dab.mot import HEADER, UNSCRAMBLED_BODY
# TX-side builders live in the package now (models/pad_writer.py)
from dab_radio_tpu.models.pad_writer import (
    build_mot_header, build_mot_segment, chunk_xpad_fields, dli_prefix,
    label_data_groups)


def test_dynamic_label():
    proc = PADProcessor()
    labels = []
    proc.on_label.append(labels.append)
    for g in label_data_groups("Now playing: DAB Radio hits!"):
        for fpad, xpad in chunk_xpad_fields(g, 2, 3):
            proc.process(fpad, xpad)
    assert labels and labels[-1] == "Now playing: DAB Radio hits!"


def test_mot_slideshow_over_xpad():
    rng = np.random.default_rng(0)
    body = rng.integers(0, 256, 500).astype(np.uint8).tobytes()
    tid = 77
    hdr = build_mot_header(body, content_name="slide.png")
    # patch content subtype to PNG (3)
    hdr = bytearray(hdr)
    hdr[5] = (hdr[5] & 0x81) | (2 << 1)          # content_type=2 image
    hdr[6] = 3                                   # subtype png
    groups = [build_mot_segment(HEADER, 0, True, tid, bytes(hdr))]
    segs = [body[i:i + 128] for i in range(0, len(body), 128)]
    for i, s in enumerate(segs):
        groups.append(build_mot_segment(UNSCRAMBLED_BODY, i,
                                        i == len(segs) - 1, tid, s))

    proc = PADProcessor()
    slides = []
    mgr = SlideshowManager()
    mgr.on_slideshow.append(slides.append)
    proc.on_mot_entity.append(mgr.process_mot_entity)
    for g in groups:
        for fpad, xpad in chunk_xpad_fields(g, 12, 13,
                                            length_prefix=dli_prefix(len(g))):
            proc.process(fpad, xpad)
    assert len(slides) == 1
    s = slides[0]
    assert s.image_type == "png"
    assert s.data == body
    assert s.name == "slide.png"


def test_aac_data_stream_element_roundtrip():
    proc = AACDataDecoder()
    labels = []
    proc.pad.on_label.append(labels.append)
    for g in label_data_groups("DSE label"):
        for fpad, xpad_rev in chunk_xpad_fields(g, 2, 3):
            au = build_data_stream_element(fpad, xpad_rev) + b"\xAA" * 10
            assert proc.process_access_unit(au)
    assert labels and labels[-1] == "DSE label"


def test_mp2_header_and_pad_location():
    from dab_radio_tpu.dab.mp2 import parse_mp2_header, locate_pad
    # MPEG-1 Layer II, 128 kbps, 48 kHz, stereo
    hdr = bytes([0xFF, 0xFC | 0b00, (8 << 4) | (1 << 2), 0x00])
    h = parse_mp2_header(hdr + b"\x00" * 100)
    assert h is not None
    assert h.sample_rate == 48000 and h.bitrate_kbps == 128
    assert h.frame_bytes == 1152 * 128000 // 8 // 48000
    frame = hdr + bytes(range(100))
    fpad, xpad = locate_pad(frame, h)
    assert fpad == frame[-2:]
    assert xpad[-1] == frame[-7]    # 4 scale-factor CRC bytes skipped


def test_slideshow_and_label_closed_loop():
    """Full air-interface closed loop for programme-associated data: the
    ensemble transmitter queues a dynamic label and a MOT slideshow onto
    a DAB+ service's X-PAD (models/pad_writer.py), and the receiver's
    channel surfaces both (dab/pad.py -> dab/mot.py -> dab/slideshow.py)."""
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.models.transmitter import (EnsembleTransmitter,
                                                  ServiceSpec)
    from dab_radio_tpu.models.demodulator import (OFDMDemodulator,
                                                  StreamingDemodulator)
    from dab_radio_tpu.models.receiver import DabReceiver
    from dab_radio_tpu.dab.aac import SuperFrameHeader

    svc = ServiceSpec(
        service_id=0xF123, subchannel_id=3, label="Radio DAB",
        cfg=SubchannelConfig(start_address=0, length=48, is_uep=False,
                             eep_type="A", eep_prot_level=2),
        superframe_header=SuperFrameHeader(48000, True, True, False, 0))
    tx = EnsembleTransmitter(1, services=[svc])
    tx.enable_tone_audio()
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, 700).astype(np.uint8).tobytes()
    tx.queue_dynamic_label(3, "Now: DAB Radio")
    tx.queue_slideshow(3, image, name="cover.png", image_type="png")

    iq = tx.generate(20)
    demod = OFDMDemodulator(1)
    sd = StreamingDemodulator(demod)
    rx = DabReceiver(1)
    lead = np.zeros(10000, np.complex64)
    for fr in sd.process(np.concatenate(
            [lead, iq, np.zeros(200000, np.complex64)])):
        rx.process_frame(fr)

    ch = rx.channels[3]
    assert ch.dynamic_label == "Now: DAB Radio"
    assert len(ch.slideshows.slideshows) == 1
    s = ch.slideshows.slideshows[0]
    assert s.name == "cover.png" and s.image_type == "png"
    assert s.data == image


def test_label_writer_validation():
    """TX label builder: DAB's 128-byte maximum and charset honesty."""
    from dab_radio_tpu.models.pad_writer import label_data_groups
    assert len(label_data_groups("x" * 128)) == 8
    with pytest.raises(ValueError):
        label_data_groups("x" * 129)
    with pytest.raises(ValueError):
        label_data_groups("Café")          # pre-encode for non-ASCII
    assert label_data_groups(b"\xc9af\xe9")     # bytes pass through
    with pytest.raises(ValueError):
        label_data_groups("")
