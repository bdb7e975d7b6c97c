"""OFDM frame-body demodulation: batched FFT, differential QPSK, frequency
deinterleave, soft-bit demap.

The reference splits 77 symbols across pipeline threads with a one-symbol FFT
halo for the differential demod (src/ofdm/ofdm_demodulator.cpp:650-766); here
the whole frame is one (S, nfft) batched FFT and the DQPSK halo is simply
fft[1:] * conj(fft[:-1]) (SURVEY.md §2.6.1).
"""

import numpy as np
import jax.numpy as jnp

from .pll import apply_pll

SOFT_HIGH = 127.0


def demod_frame_body(body: jnp.ndarray, freq_offset, *, nb_fft: int,
                     nb_symbol_period: int, nb_frame_symbols: int,
                     nb_cyclic_prefix: int, carrier_bins: jnp.ndarray,
                     carrier_map: jnp.ndarray):
    """Demodulate one aligned frame body.

    body: (..., nb_frame_symbols * nb_symbol_period) complex64 starting at the
    PRS. freq_offset: (...,) normalised CFO correction (coarse + fine).

    Returns (soft_bits (..., (S-1) * ncarriers * 2) int8,
             mean_cyclic_phase_error (...,),
             fft_frame (..., S, nb_fft) for diagnostics/GUI).
    """
    ncarr = carrier_map.shape[0]
    s = nb_frame_symbols

    # continuous-phase CFO correction across the whole frame body (the
    # reference per-symbol dt_start = i*symbol_period*f is the same ramp)
    x = apply_pll(body, freq_offset)
    syms = x.reshape(*x.shape[:-1], s, nb_symbol_period)

    # fractional-CFO metric from the cyclic prefix, averaged over symbols
    prefix = syms[..., :nb_cyclic_prefix]
    tail = syms[..., nb_fft: nb_fft + nb_cyclic_prefix]
    v = jnp.sum(tail * jnp.conj(prefix), axis=-1)
    cyclic_err = jnp.arctan2(jnp.imag(v), jnp.real(v))
    mean_cyclic_err = jnp.sum(cyclic_err, axis=-1) / s

    # cyclic prefix removal + one batched FFT over every symbol
    data = syms[..., nb_cyclic_prefix:]
    fft = jnp.fft.fft(data)                                   # (..., S, nfft)

    # differential demod between consecutive symbols, PRS as phase reference.
    # NOTE the conjugation direction: the reference demaps conj(sym_k+1)*sym_k
    # (CalculateDQPSK is called with (fft_buf_1, fft_buf_0)), which pairs with
    # its b0=-re, b1=+im QPSK demap below.
    dq = jnp.conj(fft[..., 1:, :]) * fft[..., :-1, :]         # (..., S-1, nfft)
    vec = dq[..., carrier_bins]                               # (..., S-1, ncarr)

    # L-inf normalised QPSK soft demap (reference CalculateViterbiBits)
    deint = vec[..., carrier_map]                             # logical order
    a = jnp.maximum(jnp.abs(jnp.real(deint)), jnp.abs(jnp.imag(deint)))
    a = jnp.maximum(a, 1e-20)
    b0 = -jnp.real(deint) / a * SOFT_HIGH
    b1 = jnp.imag(deint) / a * SOFT_HIGH
    bits = jnp.concatenate([b0, b1], axis=-1)                 # (..., S-1, 2*ncarr)
    # C-style float->int8 cast truncates toward zero; match it for parity
    bits = jnp.clip(jnp.trunc(bits), -127, 127).astype(jnp.int8)
    return bits.reshape(*bits.shape[:-2], (s - 1) * ncarr * 2), mean_cyclic_err, fft
