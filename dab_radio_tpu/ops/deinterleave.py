"""MSC time deinterleaver (ETSI EN 300 401 clause 12, table 21).

The reference keeps a 16-CIF circular bit history per subchannel and gathers
bit i from frame offset CIF_OFFSETS[i mod 16] of the oldest-first history
(src/dab/msc/cif_deinterleaver.cpp). Here the history is an explicit carry
array (16, nb_bits) and deinterleaving is a single static gather, batchable
over subchannels and jit-friendly.
"""

import numpy as np
import jax.numpy as jnp

CIF_OFFSETS = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15],
                       dtype=np.int32)
DEPTH = 16


def make_gather_index(nb_bits: int) -> np.ndarray:
    """index[i] = which oldest-first history row bit i is read from."""
    return CIF_OFFSETS[np.arange(nb_bits) % DEPTH]


def deinterleave_push(history: jnp.ndarray, new_cif: jnp.ndarray,
                      gather_idx: jnp.ndarray):
    """Push one CIF of soft bits and reconstruct the oldest frame.

    history: (..., 16, nb_bits) int8, row 0 = oldest. new_cif: (..., nb_bits).
    Returns (new_history, deinterleaved (..., nb_bits)). Output is valid only
    once 16 CIFs have been pushed (track the count host-side or in a carry).
    """
    new_history = jnp.concatenate(
        [history[..., 1:, :], new_cif[..., None, :]], axis=-2)
    out = jnp.take_along_axis(
        new_history,
        jnp.broadcast_to(gather_idx[None, :],
                         (*new_history.shape[:-2], 1, gather_idx.shape[0])),
        axis=-2)[..., 0, :]
    return new_history, out


def deinterleave_push_block(history: jnp.ndarray, seq: jnp.ndarray,
                            gather_idx: jnp.ndarray):
    """Push C CIFs at once — the scan-free form of C deinterleave_push calls.

    After pushing CIFs seq[0..c], the 16-row window over the concatenation
    [history ‖ seq] is rows [c+1, c+17), so output c's bit i reads row
    c + 1 + gather_idx[i]: ONE static gather replaces the C-iteration scan
    (each scan iteration would cost at least one kernel launch).

    history: (..., 16, nb_bits) oldest-first; seq: (..., C, nb_bits).
    Returns (new_history (..., 16, nb_bits), outs (..., C, nb_bits)) —
    bit-identical to scanning deinterleave_push (tests pin the equality).
    """
    C = seq.shape[-2]
    combined = jnp.concatenate([history, seq], axis=-2)   # (..., 16+C, nb)
    idx = jnp.arange(1, C + 1, dtype=jnp.int32)[:, None] + gather_idx[None, :]
    outs = jnp.take_along_axis(
        combined,
        jnp.broadcast_to(idx, (*combined.shape[:-2], C, gather_idx.shape[0])),
        axis=-2)
    return combined[..., C:, :], outs
