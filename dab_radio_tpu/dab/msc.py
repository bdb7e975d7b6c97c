"""MSC subchannel decoder: CIF slice -> time deinterleave -> punctured
Viterbi -> energy-dispersal descramble.

Parity surface: reference src/dab/msc/msc_decoder.cpp + cif_deinterleaver.cpp.
The deinterleaver history is an explicit (16, nb_bits) carry and the Viterbi
runs on device; an encoder inverse (interleave + encode) supports closed-loop
tests and the ensemble transmitter.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import viterbi as vit
from ..ops.deinterleave import (make_gather_index, deinterleave_push,
                                deinterleave_push_block, DEPTH, CIF_OFFSETS)
from ..ops.scrambler import prbs_bytes
from ..params import msc_puncture_schedule, SubchannelConfig
from ..params.puncture import build_puncture_mask

CU_BITS = 64

# MSC Viterbi mode: "exact" = full-trellis radix-4 scan (reference
# semantics); "tiled" = overlap-save chunked decode (ops/viterbi.py
# viterbi_decode_tiled) — up to ~16x lower decode latency, equal output at
# operating SNR, per-layer CRCs gate the pathological-noise corner.
_DECODE_MODE = "exact"


def set_decode_mode(mode: str) -> None:
    global _DECODE_MODE
    assert mode in ("exact", "tiled")
    if mode != _DECODE_MODE:
        _DECODE_MODE = mode
        _decoder_fns.cache_clear()
        _group_frame_fn.cache_clear()


def _vit_decode(soft, spec):
    if _DECODE_MODE == "tiled":
        bits, _ = vit.viterbi_decode_tiled(soft, spec)
        return bits, None
    return vit.viterbi_decode(soft, spec)


@functools.lru_cache(maxsize=None)
def _decoder_fns(cfg: SubchannelConfig):
    """Jitted per-CIF and per-frame decode steps, shared across all
    MSCDecoder instances with the same subchannel configuration (channels
    are recreated per run/ensemble; recompiling per instance would dominate
    startup at many-ensemble scale)."""
    spec = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(cfg))
    gather_idx = jnp.asarray(make_gather_index(cfg.nb_cif_bits))

    @jax.jit
    def step(history, cif_soft):
        new_hist, deint = deinterleave_push(history, cif_soft, gather_idx)
        bits, err = _vit_decode(deint[None, ..., :spec.nb_in], spec)
        return new_hist, bits[0], err

    @jax.jit
    def frame(history, cifs_soft):
        history, deints = deinterleave_push_block(history, cifs_soft,
                                                  gather_idx)
        bits, err = _vit_decode(deints[..., :spec.nb_in], spec)
        return history, bits, err

    return spec, step, frame


@functools.lru_cache(maxsize=None)
def _group_frame_fn(norm_cfg: SubchannelConfig):
    """Jitted frame decode batched over N same-protection subchannels:
    histories (N, DEPTH, nb_bits) + cifs (N, nb_cifs, nb_bits) in one
    dispatch. The reference fans a thread-pool task per subchannel
    (basic_radio.cpp:55-60); here same-shaped subchannels share one
    batched Viterbi so the trellis scan runs at N*nb_cifs lanes."""
    spec = vit.ViterbiSpec.from_schedule(msc_puncture_schedule(norm_cfg))
    gather_idx = jnp.asarray(make_gather_index(norm_cfg.nb_cif_bits))

    @jax.jit
    def frame_batch(histories, cifs_soft):
        histories, deints = deinterleave_push_block(histories, cifs_soft,
                                                    gather_idx)
        deints = deints[..., :spec.nb_in]
        n, c, length = deints.shape
        bits, err = _vit_decode(deints.reshape(n * c, length), spec)
        return histories, bits.reshape(n, c, -1), err

    return frame_batch


def group_key(cfg: SubchannelConfig) -> SubchannelConfig:
    """Subchannels that differ only in start address share decode shapes."""
    return dataclasses.replace(cfg, start_address=0)


class MSCDecodeGroup:
    """Persistent same-protection decode group: the stacked deinterleaver
    history lives on device across rounds (one jit call per round, no
    per-channel eager slicing — each eager op is a device round trip).
    Use sync_back() before using the individual
    MSCDecoder objects again."""

    def __init__(self, decoders: list):
        self.decoders = list(decoders)
        self.key = group_key(decoders[0].cfg)
        self._frame_batch = _group_frame_fn(self.key)
        self.hist = jnp.stack([d.history for d in self.decoders])

    def dispatch(self, cifs_list):
        # generic over host (np) and device (jnp) CIF arrays: slicing stays
        # lazy on device, so a device-resident demod output chains into the
        # MSC decode without a host round trip
        subs = jnp.stack([
            c[:, d.cfg.start_address * CU_BITS:
               d.cfg.start_address * CU_BITS + d.nb_bits]
            for d, c in zip(self.decoders, cifs_list)])
        self.hist, bits, _err = self._frame_batch(self.hist, subs)
        pushed0 = []
        nb_cifs = subs.shape[1]
        for d in self.decoders:
            pushed0.append(d.nb_pushed)
            d.nb_pushed += nb_cifs
        return self.decoders, bits, pushed0, nb_cifs

    def sync_back(self):
        for i, d in enumerate(self.decoders):
            d.history = self.hist[i]


def dispatch_frame_group(decoders: list, msc_cifs):
    """Device half of decode_frame_group: one batched dispatch over N
    same-protection subchannels. Updates each decoder's deinterleaver
    history (device array, no host fetch) and returns a handle for
    finalize_frame_group — the host fetch can be deferred to overlap later
    dispatches (double-buffered host<->device pipelining, SURVEY §2.6.2)."""
    if isinstance(msc_cifs, (list, tuple)):
        cifs_list = list(msc_cifs)
    else:
        cifs_list = [msc_cifs] * len(decoders)
    g = MSCDecodeGroup(decoders)
    handle = g.dispatch(cifs_list)
    g.sync_back()
    return handle


def finalize_frame_group(handle) -> list:
    """Host half: fetch decoded bits, descramble, emit per-decoder payload
    lists matching MSCDecoder.decode_frame."""
    decoders, bits, pushed0, nb_cifs = handle
    bits = np.asarray(bits, np.uint8)
    results = []
    for i, d in enumerate(decoders):
        out = []
        for c in range(nb_cifs):
            if pushed0[i] + c + 1 < DEPTH:
                out.append(None)
                continue
            by = np.packbits(bits[i, c])
            out.append(bytes(by ^ prbs_bytes(by.shape[0])))
        results.append(out)
    return results


def decode_frame_group(decoders: list, msc_cifs) -> list:
    """Decode one frame of several same-protection subchannels in a single
    device dispatch. msc_cifs is one (nb_cifs, nb_msc_cif_bits) array shared
    by every decoder (subchannels of one ensemble) or a sequence of such
    arrays, one per decoder (subchannels drawn from different ensembles in a
    fleet). Returns per-decoder lists matching MSCDecoder.decode_frame."""
    return finalize_frame_group(dispatch_frame_group(decoders, msc_cifs))


class MSCDecoder:
    """Streaming decoder for one subchannel (per-CIF)."""

    def __init__(self, cfg: SubchannelConfig):
        self.cfg = cfg
        self.nb_bits = cfg.nb_cif_bits
        self.spec, self._step, self._frame = _decoder_fns(cfg)
        # NumPy, not jnp: channel creation happens inside the host byte
        # layer (receiver._update_channels) and must not dispatch to the
        # device; the first jitted decode call promotes it on device
        self.history = np.zeros((DEPTH, self.nb_bits), np.int8)
        self.nb_pushed = 0

    # checkpoint/resume (SURVEY §5.4): the carry is the deinterleaver
    # history + fill counter; jitted fns rebuild from the config
    def __getstate__(self):
        return {"cfg": self.cfg, "nb_pushed": self.nb_pushed,
                "history": np.asarray(self.history)}

    def __setstate__(self, state):
        self.cfg = state["cfg"]
        self.nb_bits = self.cfg.nb_cif_bits
        self.spec, self._step, self._frame = _decoder_fns(self.cfg)
        self.history = state["history"]     # np; device-promoted on use
        self.nb_pushed = state["nb_pushed"]

    def decode_cif(self, msc_soft_bits: np.ndarray):
        """msc_soft_bits: one CIF of soft bits (nb_cif_bits of the whole MSC).
        Returns decoded bytes (descrambled) or None while the deinterleaver
        is still filling."""
        start = self.cfg.start_address * CU_BITS
        sub = np.asarray(msc_soft_bits)[start:start + self.nb_bits]
        self.history, bits, err = self._step(self.history, jnp.asarray(sub))
        self.nb_pushed += 1
        if self.nb_pushed < DEPTH:
            return None
        by = np.packbits(np.asarray(bits, np.uint8))
        return bytes(by ^ prbs_bytes(by.shape[0]))

    def decode_frame(self, msc_cifs: np.ndarray):
        """All CIFs of one frame: (nb_cifs, nb_msc_cif_bits) -> list of
        decoded byte payloads (None entries while the deinterleaver fills)."""
        nb_cifs = msc_cifs.shape[0]
        start = self.cfg.start_address * CU_BITS
        sub = np.asarray(msc_cifs)[:, start:start + self.nb_bits]
        self.history, bits, err = self._frame(self.history, jnp.asarray(sub))
        bits = np.asarray(bits, np.uint8)
        out = []
        for c in range(nb_cifs):
            self.nb_pushed += 1
            if self.nb_pushed < DEPTH:
                out.append(None)
                continue
            by = np.packbits(bits[c])
            out.append(bytes(by ^ prbs_bytes(by.shape[0])))
        return out


class MSCEncoder:
    """Inverse path for tests/transmitter: payload bytes -> interleaved CIF
    soft bits of the subchannel."""

    def __init__(self, cfg: SubchannelConfig):
        self.cfg = cfg
        self.nb_bits = cfg.nb_cif_bits
        self.mask = build_puncture_mask(msc_puncture_schedule(cfg))
        self.nb_data_bits = self.mask.shape[0] // 4 - 6
        self.nb_data_bytes = self.nb_data_bits // 8
        # interleaver state: future CIF contributions (bit i of the CIF sent
        # at time t+offset comes from the frame encoded at time t)
        self._pending = np.zeros((DEPTH, self.nb_bits), dtype=np.int8)
        self._t = 0

    def encode_cif(self, payload: bytes) -> np.ndarray:
        """Encode one logical frame and emit the time-interleaved CIF soft
        bits that would be transmitted this CIF period (includes
        contributions from the previous 15 logical frames)."""
        assert len(payload) == self.nb_data_bytes
        data = np.frombuffer(payload, dtype=np.uint8) ^ prbs_bytes(self.nb_data_bytes)
        bits = np.unpackbits(data)
        coded = vit.conv_encode(bits)
        tx = vit.bits_to_soft(vit.puncture(coded, self.mask))
        if tx.shape[0] < self.nb_bits:    # UEP padding bits
            tx = np.concatenate([tx, np.zeros(self.nb_bits - tx.shape[0], np.int8)])

        # scatter: bit i of this frame goes out at time t + offset[i%16]
        offs = CIF_OFFSETS[np.arange(self.nb_bits) % DEPTH]
        for d in range(DEPTH):
            sel = offs == d
            self._pending[(self._t + d) % DEPTH][sel] = tx[sel]
        out = self._pending[self._t % DEPTH].copy()
        self._t += 1
        return out
