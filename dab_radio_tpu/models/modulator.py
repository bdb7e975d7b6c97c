"""OFDM modulator (transmitter) for DAB transmission modes I-IV.

Accelerator inverse path of the demodulator (reference: src/ofdm/
ofdm_modulator.cpp:49-156): QPSK-map logical bits, frequency-interleave onto
physical carriers, accumulate the differential phase across symbols with a
parallel associative scan (instead of the reference's sequential
symbol-by-symbol loop), batched IFFT, cyclic prefix via concatenation.

Bit convention: input bits are in the *demodulator output order* — for data
symbol s, bits[s, i] is b0 and bits[s, i + ncarriers] is b1 of logical carrier
i (so modulate -> demodulate -> hard decision is the identity). The reference
transmitter's byte format maps bit pairs straight onto physical carriers
without interleaving; `modulate_reference_bytes` reproduces that contract for
the simulate_transmitter app.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..params import get_ofdm_params, get_prs_reference
from ..params.mapper import get_carrier_mapper, get_carrier_to_fft_bin


class OFDMModulator:
    def __init__(self, transmission_mode: int = 1):
        self.params = get_ofdm_params(transmission_mode)
        p = self.params
        self.prs_fft = get_prs_reference(transmission_mode, p.nb_fft)
        self.carrier_map = get_carrier_mapper(p.nb_fft, p.nb_data_carriers)
        self.carrier_bins = get_carrier_to_fft_bin(p.nb_fft, p.nb_data_carriers)
        # PRS spectrum restricted to the data-carrier slots (phase seed)
        self.prs_slots = self.prs_fft[self.carrier_bins]
        # the host<->device wire format is f32 (..., 2) IQ pairs
        # (ops/iq.py), so this jit emits pairs rather than complex64
        from ..ops.iq import iq_pairs as _iq_pairs
        self._frame_pairs_fn = jax.jit(
            lambda b: _iq_pairs(self.modulate_frame(b)))

    def modulate_frame_pairs(self, bits: jnp.ndarray) -> jnp.ndarray:
        """modulate_frame, but returns float32 (..., nb_frame_samples, 2) IQ
        pairs — the only layout that can be fetched from every backend."""
        return self._frame_pairs_fn(bits)

    def modulate_frame(self, bits: jnp.ndarray) -> jnp.ndarray:
        """bits: (..., S-1, 2*ncarriers) or (..., (S-1)*2*ncarriers) 0/1.
        Returns (..., nb_frame_samples) complex64: NULL + PRS + data symbols."""
        p = self.params
        ncarr = p.nb_data_carriers
        s_data = p.nb_data_symbols
        bits = jnp.asarray(bits).reshape(*jnp.shape(bits)[:-1], s_data, 2 * ncarr) \
            if bits.ndim >= 1 and bits.shape[-1] == s_data * 2 * ncarr else jnp.asarray(bits)
        assert bits.shape[-2:] == (s_data, 2 * ncarr), bits.shape

        b0 = bits[..., :ncarr].astype(jnp.float32)
        b1 = bits[..., ncarr:].astype(jnp.float32)
        amp = 1.0 / np.sqrt(2.0)
        q_logical = ((1.0 - 2.0 * b0) + 1j * (1.0 - 2.0 * b1)) * amp

        # frequency interleave: logical carrier i -> physical slot map[i]
        inv = np.empty(ncarr, dtype=np.int32)
        inv[self.carrier_map] = np.arange(ncarr, dtype=np.int32)
        q_slots = q_logical[..., jnp.asarray(inv)]            # (..., S-1, ncarr)

        # differential accumulation: sym_k = PRS * prod_{m<=k} q_m
        prs = jnp.asarray(self.prs_slots)[None, :]
        seq = jnp.concatenate([jnp.broadcast_to(
            prs, (*q_slots.shape[:-2], 1, ncarr)), q_slots], axis=-2)
        spec_slots = jax.lax.associative_scan(jnp.multiply, seq, axis=-2)

        # scatter slots into FFT bins
        spec = jnp.zeros((*spec_slots.shape[:-1], p.nb_fft), jnp.complex64)
        spec = spec.at[..., jnp.asarray(self.carrier_bins)].set(
            spec_slots.astype(jnp.complex64))

        td = jnp.fft.ifft(spec) * p.nb_fft                    # FFTW-style unnormalised
        sym = jnp.concatenate([td[..., -p.nb_cyclic_prefix:], td], axis=-1)
        body = sym.reshape(*sym.shape[:-2],
                           p.nb_frame_symbols * p.nb_symbol_period)
        null = jnp.zeros((*body.shape[:-1], p.nb_null_period), jnp.complex64)
        return jnp.concatenate([null, body], axis=-1).astype(jnp.complex64)

    def modulate_stream(self, frames_bits: jnp.ndarray) -> jnp.ndarray:
        """(F, S-1, 2*ncarr) bits -> concatenated multi-frame IQ stream."""
        frames = self.modulate_frame(frames_bits)
        return frames.reshape(-1)

    def modulate_reference_bytes(self, data: np.ndarray) -> np.ndarray:
        """Reference byte contract (ofdm_modulator.cpp CreateDataSymbol):
        2-bit groups map directly onto physical carriers, first half of each
        symbol's bytes fill the negative frequencies. For the
        simulate_transmitter app; returns one frame of IQ as numpy."""
        p = self.params
        ncarr = p.nb_data_carriers
        nbytes_sym = ncarr * 2 // 8
        data = np.asarray(data, dtype=np.uint8).reshape(p.nb_data_symbols, nbytes_sym)
        amp = 1.0 / np.sqrt(2.0)
        phase_map = np.array([-amp - 1j * amp, amp - 1j * amp,
                              amp + 1j * amp, -amp + 1j * amp], np.complex64)
        shifts = np.arange(4) * 2
        pairs = (data[..., :, None] >> shifts[None, None, :]) & 0b11
        q = phase_map[pairs.reshape(p.nb_data_symbols, -1)]   # (S-1, ncarr)
        # slots ordered negative-then-positive == carrier_bins layout
        spec_slots = np.cumprod(
            np.concatenate([self.prs_slots[None, :], q], axis=0), axis=0)
        spec = np.zeros((p.nb_frame_symbols, p.nb_fft), np.complex64)
        spec[:, self.carrier_bins] = spec_slots
        td = np.fft.ifft(spec, axis=-1) * p.nb_fft
        sym = np.concatenate([td[:, -p.nb_cyclic_prefix:], td], axis=-1)
        out = np.concatenate([np.zeros(p.nb_null_period, np.complex64),
                              sym.reshape(-1)])
        return out.astype(np.complex64)
