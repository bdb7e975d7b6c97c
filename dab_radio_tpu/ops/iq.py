"""IQ sample layout at the host<->device boundary.

Convention: every public device entry point takes IQ as
float32 with a trailing axis of 2 (re, im) — "IQ pairs" — and rebuilds
complex64 *inside* the jitted computation, where XLA handles it natively.
One wire format keeps the host feeders, the u8 dequantizer and every
jitted entry point on the same (..., 2) layout.

For contiguous numpy complex64 the conversion is a zero-copy view (the
memory layout of c64 is exactly [re, im] f32 pairs), so the host feeder
pays nothing (reference analog: the u8-IQ wire format of rtl_sdr,
examples/rtl_sdr.cpp — samples travel as scalar pairs, not complex).
"""

import numpy as np
import jax
import jax.numpy as jnp


def iq_pairs(x):
    """complex IQ (numpy or jax) -> float32 (..., 2); pairs pass through."""
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            x = np.ascontiguousarray(x, dtype=np.complex64)
            return x.view(np.float32).reshape(x.shape + (2,))
        return np.asarray(x, dtype=np.float32)
    if jnp.iscomplexobj(x):
        return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)
    return x


def pairs_to_complex(x: jnp.ndarray) -> jnp.ndarray:
    """float32 (..., 2) -> complex64 (...). Use inside jit only."""
    return jax.lax.complex(x[..., 0], x[..., 1])


def pairs_to_complex_np(x: np.ndarray) -> np.ndarray:
    """Host-side inverse of iq_pairs (zero-copy for contiguous f32)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return x.view(np.complex64).reshape(x.shape[:-1])
