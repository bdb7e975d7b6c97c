"""Streaming OFDM demodulator — the flagship compute model.

Accelerator re-design of the reference's 5-state sample-consuming machine
(src/ofdm/ofdm_demodulator.cpp): demodulation is a fixed-shape, jittable
`frame_step(carry, window)` over one frame-sized window plus a timing margin,
with all synchronisation state in an explicit carry pytree. The host driver
only moves a read pointer (acquisition / per-frame timing drift); every FLOP
runs on device. Batch a leading axis (many ensembles) with jax.vmap, shard it
over a Mesh (parallel/).

Per frame the step performs, exactly mirroring the reference's tracking loop:
  1. running L1 signal average update (AGC reference for null-dip search)
  2. coarse integral CFO by PRS relative-phase correlation (fast/slow blend)
  3. fine time sync by PRS matched filter (desync reset if peak < 20 dB)
  4. CFO-corrected batched FFT demod of all 76 symbols
  5. differential QPSK + frequency deinterleave + int8 soft-bit demap
  6. fractional CFO update from the cyclic-prefix phase error
"""

from dataclasses import dataclass
import functools
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..params import get_ofdm_params, get_prs_reference
from ..params.mapper import get_carrier_mapper, get_carrier_to_fft_bin
from ..ops import sync as sync_ops
from ..ops.demod import demod_frame_body
from ..ops.iq import iq_pairs, pairs_to_complex
from ..utils.profiler import profile_scope


@dataclass(frozen=True)
class DemodConfig:
    """Sync hyperparameters (reference OFDM_Demod_Config)."""
    signal_l1_beta: float = 0.95
    null_search_nb_samples: int = 100
    thresh_null_start: float = 0.35
    thresh_null_end: float = 0.75
    fine_freq_beta: float = 0.9
    enable_coarse_freq: bool = True
    max_coarse_freq_norm: float = 0.5
    coarse_slow_beta: float = 0.1
    impulse_peak_threshold_db: float = 20.0
    impulse_peak_distance_prob: float = 0.15
    # apply the measured fractional CFO within the same frame when it
    # exceeds this many FFT bins (improves on the reference, which always
    # applies it one frame late and wastes the first frame after lock);
    # small errors keep the smoothed carry path to avoid jitter at low SNR
    fine_sameframe_bins: float = 0.05


class DemodCarry(NamedTuple):
    """Per-stream synchronisation state carried between frames."""
    freq_coarse: jnp.ndarray     # f32, normalised
    freq_fine: jnp.ndarray       # f32, normalised
    is_coarse_found: jnp.ndarray  # bool
    signal_l1_avg: jnp.ndarray   # f32
    total_frames: jnp.ndarray    # i32
    total_desync: jnp.ndarray    # i32

    @classmethod
    def init(cls, batch_shape=()) -> "DemodCarry":
        z = lambda dt: jnp.zeros(batch_shape, dt)
        return cls(z(jnp.float32), z(jnp.float32), z(jnp.bool_),
                   z(jnp.float32), z(jnp.int32), z(jnp.int32))


class OFDMDemodulator:
    """Holds the static mode constants and the jitted frame step."""

    def __init__(self, transmission_mode: int = 1,
                 config: DemodConfig = DemodConfig()):
        self.mode = transmission_mode
        self.cfg = config
        self.params = p = get_ofdm_params(transmission_mode)

        prs = get_prs_reference(transmission_mode, p.nb_fft)
        # complex constants are stored as f32 pairs and rebuilt inside jit:
        # complex buffers must never cross the host<->device boundary
        # (ops/iq.py)
        self.prs_fft_conj = iq_pairs(np.conj(prs))
        self.prs_time_corr_ref = iq_pairs(
            np.asarray(sync_ops.make_prs_time_correlation_ref(prs)))
        self.carrier_map = get_carrier_mapper(p.nb_fft, p.nb_data_carriers)
        self.carrier_bins = get_carrier_to_fft_bin(p.nb_fft, p.nb_data_carriers)

        self.body_len = p.nb_frame_symbols * p.nb_symbol_period
        self.margin = p.nb_symbol_period          # timing drift search span
        self.window_len = p.nb_null_period + self.body_len + self.margin
        self.frame_advance = p.nb_frame_samples   # nominal samples per frame

        self._frame_step = jax.jit(self._frame_step_impl)
        self._frame_step_batch = jax.jit(jax.vmap(self._frame_step_impl))
        self._acquire = jax.jit(self._acquire_impl)
        self._l1 = jax.jit(
            lambda pr: sync_ops.l1_average(pairs_to_complex(pr)))

    # ---------------- device ops ----------------

    def _frame_step_impl(self, carry: DemodCarry, window: jnp.ndarray):
        window = pairs_to_complex(window)      # (window_len, 2) f32 in
        p, cfg = self.params, self.cfg
        nfft, cp = p.nb_fft, p.nb_cyclic_prefix

        # 1. signal level EMA (frame-granularity update of the reference's
        # block-wise running average; the null is ~1% of the window)
        measured = sync_ops.l1_average(window)
        l1 = jnp.where(carry.signal_l1_avg > 0,
                       cfg.signal_l1_beta * carry.signal_l1_avg
                       + (1 - cfg.signal_l1_beta) * measured,
                       measured)

        prs_rx = jax.lax.dynamic_slice_in_dim(window, p.nb_null_period, nfft, -1)

        # 2. coarse integral CFO
        if cfg.enable_coarse_freq:
            pred = sync_ops.coarse_freq_estimate(
                prs_rx, pairs_to_complex(jnp.asarray(self.prs_time_corr_ref)),
                nfft, cfg.max_coarse_freq_norm)
            coarse, delta_c = sync_ops.coarse_freq_update(
                pred, carry.freq_coarse, carry.is_coarse_found, nfft,
                cfg.coarse_slow_beta)
            fine = sync_ops.wrap_fine_offset(carry.freq_fine - delta_c, nfft)
        else:
            coarse = jnp.zeros_like(carry.freq_coarse)
            fine = carry.freq_fine

        # 3. fine time sync on the CFO-corrected PRS
        offset, sync_ok, _ = sync_ops.fine_time_offset(
            prs_rx, pairs_to_complex(jnp.asarray(self.prs_fft_conj)),
            coarse + fine,
            nfft, cp, p.nb_symbol_period,
            cfg.impulse_peak_threshold_db, cfg.impulse_peak_distance_prob)
        offset = jnp.clip(offset, -cp, self.margin)

        # 4-5. aligned frame body -> soft bits
        start = p.nb_null_period + offset
        body = jax.lax.dynamic_slice_in_dim(window, start, self.body_len, -1)

        # measure the fractional CFO on this window first; a large residual
        # (post-lock, CFO step) is corrected within the same frame instead of
        # costing a garbage frame like the reference's apply-next-frame loop
        if cfg.fine_sameframe_bins > 0:
            from ..ops.pll import apply_pll
            syms_pre = apply_pll(body, coarse + fine).reshape(
                *body.shape[:-1], p.nb_frame_symbols, p.nb_symbol_period)
            ferr_pre = sync_ops.fine_freq_error(
                sync_ops.cyclic_phase_error(syms_pre, nfft, cp), nfft)
            big = jnp.abs(ferr_pre) > (cfg.fine_sameframe_bins / nfft)
            fine = jnp.where(
                big, sync_ops.wrap_fine_offset(fine - ferr_pre, nfft), fine)

        bits, cyc_err, _ = demod_frame_body(
            body, coarse + fine, nb_fft=nfft,
            nb_symbol_period=p.nb_symbol_period,
            nb_frame_symbols=p.nb_frame_symbols,
            nb_cyclic_prefix=cp,
            carrier_bins=jnp.asarray(self.carrier_bins),
            carrier_map=jnp.asarray(self.carrier_map))

        # 6. fractional CFO update (used from the next frame on)
        ferr = sync_ops.fine_freq_error(cyc_err, nfft)
        fine2 = sync_ops.wrap_fine_offset(fine - cfg.fine_freq_beta * ferr, nfft)

        tracked = DemodCarry(coarse, fine2, jnp.ones_like(carry.is_coarse_found),
                             l1, carry.total_frames + 1, carry.total_desync)
        reset = DemodCarry(jnp.zeros_like(coarse), jnp.zeros_like(fine2),
                           jnp.zeros_like(carry.is_coarse_found),
                           l1, carry.total_frames, carry.total_desync + 1)
        new_carry = jax.tree.map(lambda a, b: jnp.where(sync_ok, a, b),
                                 tracked, reset)
        return new_carry, {"bits": bits, "sync_ok": sync_ok, "offset": offset}

    def _acquire_impl(self, block: jnp.ndarray, l1_avg: jnp.ndarray):
        block = pairs_to_complex(block)
        cfg = self.cfg
        return sync_ops.find_null_dip(
            block, l1_avg, nb_block=cfg.null_search_nb_samples,
            thresh_start=cfg.thresh_null_start, thresh_end=cfg.thresh_null_end)

    def _frame_scan_impl(self, nb_frames: int, carry: DemodCarry,
                         buf: jnp.ndarray):
        """nb_frames sequential frame steps in ONE device program.

        buf: (nb_frames * frame_advance + window_len, 2) f32 pairs. The scan
        carries the read position: each frame's timing-drift offset advances
        the next frame's window (the host driver's pointer arithmetic moves
        on-device; clamped to the buffer so every slice is in bounds). On
        desync the remaining frames are masked invalid rather than
        re-acquired (the host falls back to acquisition as usual)."""
        max_pos = nb_frames * self.frame_advance

        def step(state, _):
            c, pos, alive = state
            window = jax.lax.dynamic_slice_in_dim(buf, pos, self.window_len, 0)
            new_c, out = self._frame_step_impl(c, window)
            ok = jnp.logical_and(out["sync_ok"], alive)
            c2 = jax.tree.map(lambda n, o: jnp.where(alive, n, o), new_c, c)
            pos2 = jnp.where(ok, pos + out["offset"] + self.frame_advance,
                             pos)
            pos2 = jnp.clip(pos2, 0, max_pos)
            return (c2, pos2, ok), {"bits": out["bits"], "valid": ok}

        (carry, pos, _), outs = jax.lax.scan(
            step, (carry, jnp.asarray(0, jnp.int32), jnp.asarray(True)), None,
            length=nb_frames)
        return carry, pos, outs

    @functools.lru_cache(maxsize=8)
    def _frame_scan(self, nb_frames: int):
        return jax.jit(partial(self._frame_scan_impl, nb_frames))

    def frame_scan(self, nb_frames: int, carry: DemodCarry, buf):
        """Demodulate up to nb_frames consecutive frames in one dispatch.
        buf: (nb_frames*frame_advance + window_len,) complex or (..., 2) f32
        pairs. Returns (carry, consumed_samples, {bits (F, nb_bits),
        valid (F,)}) — valid goes False at the first desync."""
        return self._frame_scan(nb_frames)(carry, iq_pairs(buf))

    def frame_step(self, carry: DemodCarry, window: jnp.ndarray):
        """Jitted single-stream step; window shape (window_len,) complex or
        (window_len, 2) float32 IQ pairs (the device wire format)."""
        return self._frame_step(carry, iq_pairs(window))

    def frame_step_batch(self, carry: DemodCarry, windows: jnp.ndarray):
        """Jitted vmapped step; windows shape (B, window_len) complex or
        (B, window_len, 2) float32 IQ pairs."""
        return self._frame_step_batch(carry, iq_pairs(windows))


class _StreamBuffer:
    """Amortized-O(chunk) ingest buffer (replaces per-chunk np.concatenate;
    reference keeps a reconstruction ring, src/ofdm/reconstruction_buffer.h).

    Live samples sit in one preallocated array between ``_start``/``_end``;
    append writes in place, consume advances the start pointer, and the live
    span is only copied down when the tail hits capacity. ``view`` returns
    zero-copy slices — callers that retain data across ``append`` must copy.
    """

    def __init__(self, dtype=np.complex64, capacity: int = 1 << 16):
        self._arr = np.empty(capacity, dtype)
        self._start = 0
        self._end = 0

    def __len__(self):
        return self._end - self._start

    def append(self, x: np.ndarray):
        n = x.shape[0]
        if self._end + n > self._arr.shape[0]:
            live = len(self)
            cap = self._arr.shape[0]
            while cap < 2 * (live + n):  # keep headroom: compaction stays rare
                cap *= 2
            if cap != self._arr.shape[0]:
                new = np.empty(cap, self._arr.dtype)
                new[:live] = self._arr[self._start:self._end]
                self._arr = new
            else:
                self._arr[:live] = self._arr[self._start:self._end]
            self._start, self._end = 0, live
        self._arr[self._end:self._end + n] = x
        self._end += n

    def view(self, a: int, b: int) -> np.ndarray:
        return self._arr[self._start + a:self._start + b]

    def consume(self, n: int):
        self._start = min(self._start + n, self._end)

    def to_array(self) -> np.ndarray:
        return self._arr[self._start:self._end].copy()

    def set(self, data: np.ndarray):
        self._start, self._end = 0, 0
        self.append(np.asarray(data, self._arr.dtype))


class StreamingDemodulator:
    """Host-side streaming driver over one IQ stream.

    Owns a growable sample buffer and a read pointer; alternates between
    device-side acquisition (null-dip search) and per-frame tracking. Emits
    one int8 soft-bit array per locked frame, mirroring On_OFDM_Frame."""

    ACQUIRE, TRACK = 0, 1

    def __init__(self, demod: OFDMDemodulator, frames_per_step: int = 1):
        self.demod = demod
        self.carry = DemodCarry.init()
        self.state = self.ACQUIRE
        self._buf = _StreamBuffer()
        self._l1 = 0.0
        self.last_window = None  # most recent tracked frame window (debug)
        # frames_per_step > 1 fuses K tracking steps into one device program
        # (lax.scan threads the timing-drift pointer on-device), amortizing
        # dispatch overhead K-fold
        self.frames_per_step = max(1, frames_per_step)

    def reset(self):
        self.carry = DemodCarry.init()
        self.state = self.ACQUIRE

    # ---- checkpoint/resume (SURVEY.md §5.4: all decode state is explicit) ----

    def snapshot(self) -> dict:
        import numpy as _np
        return {
            "carry": [_np.asarray(x) for x in self.carry],
            "state": self.state,
            "buf": self._buf.to_array(),
            "l1": self._l1,
        }

    def restore(self, snap: dict):
        import jax.numpy as _jnp
        self.carry = DemodCarry(*[_jnp.asarray(x) for x in snap["carry"]])
        self.state = snap["state"]
        self._buf = _StreamBuffer()
        self._buf.set(snap["buf"])
        self._l1 = snap["l1"]

    def process(self, iq: np.ndarray):
        """Consume an arbitrary-size chunk of complex64 IQ; yields soft-bit
        frames (np.int8 arrays) as they lock."""
        d = self.demod
        p = d.params
        self._buf.append(np.asarray(iq, np.complex64))
        frames = []
        ptr = 0
        while True:
            avail = len(self._buf) - ptr
            if self.state == self.ACQUIRE:
                acq_len = d.window_len
                if avail < acq_len:
                    break
                with profile_scope("demod/acquire"):
                    block = jnp.asarray(
                        iq_pairs(self._buf.view(ptr, ptr + acq_len)))
                if self._l1 == 0.0:
                    self._l1 = float(d._l1(block))
                found, end_idx = d._acquire(block, jnp.float32(self._l1))
                self._l1 = 0.7 * self._l1 + 0.3 * float(d._l1(block))
                if bool(found):
                    # rewind past the dip-search granularity so the timing
                    # error is positive (the fine-time margin covers late
                    # windows; an early window only has the cyclic prefix)
                    rewind = 2 * self.demod.cfg.null_search_nb_samples
                    null_start = (ptr + int(end_idx)
                                  - p.nb_null_period - rewind)
                    ptr = max(null_start, ptr)
                    self.state = self.TRACK
                    prev = self.carry
                    # fresh sync state, but cumulative counters survive
                    # re-acquisition (reference m_total_frames_*)
                    self.carry = DemodCarry.init()._replace(
                        signal_l1_avg=jnp.float32(self._l1),
                        total_frames=prev.total_frames,
                        total_desync=prev.total_desync)
                else:
                    ptr += acq_len - p.nb_null_period
            else:
                K = self.frames_per_step
                scan_len = K * d.frame_advance + d.window_len
                if K > 1 and avail >= scan_len:
                    with profile_scope("demod/frame_scan"):
                        raw = self._buf.view(ptr, ptr + scan_len)
                        carry, consumed, outs = d.frame_scan(
                            K, self.carry, jnp.asarray(iq_pairs(raw)))
                        valid, bits = jax.device_get(
                            (outs["valid"], outs["bits"]))
                    self.carry = carry
                    nb_ok = int(valid.sum())
                    for k in range(nb_ok):
                        frames.append(bits[k])
                    self.last_window = raw[:d.window_len].copy()
                    ptr += int(consumed)
                    if nb_ok < K:
                        self.state = self.ACQUIRE
                        ptr += p.nb_null_period
                    continue
                if avail < d.window_len:
                    break
                with profile_scope("demod/frame_step"):
                    raw_window = self._buf.view(ptr, ptr + d.window_len)
                    window = jnp.asarray(iq_pairs(raw_window))
                    self.carry, out = d.frame_step(self.carry, window)
                self.last_window = raw_window.copy()  # diagnostics/GUI hook
                if bool(out["sync_ok"]):
                    frames.append(np.asarray(out["bits"]))
                    ptr += int(out["offset"]) + d.frame_advance
                else:
                    # desync: re-acquire, advancing past the failed region so
                    # the search always makes forward progress
                    self.state = self.ACQUIRE
                    ptr += p.nb_null_period
        self._buf.consume(ptr)
        return frames
