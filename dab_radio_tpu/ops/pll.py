"""Frequency-shift (PLL) mixing.

y(t) = x(t) * e^{j 2 pi f (t0 + t)} with f normalised to the sample rate.
The reference hand-vectorises this with a Chebyshev sine (src/ofdm/dsp/
apply_pll.cpp); here it is a fused elementwise complex multiply XLA
generates directly.
"""

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def apply_pll(x: jnp.ndarray, freq_norm, t0=0.0) -> jnp.ndarray:
    """Mix x (..., N) complex64 by normalised frequency freq_norm (broadcastable
    leading dims), starting at sample offset t0."""
    n = x.shape[-1]
    t = jnp.arange(n, dtype=jnp.float32)
    phase = TWO_PI * (jnp.asarray(freq_norm, jnp.float32)[..., None]
                      * (t + jnp.asarray(t0, jnp.float32)[..., None]))
    rot = jnp.exp(1j * phase.astype(jnp.float32)).astype(jnp.complex64)
    return x * rot
