"""Punctured convolutional codec for DAB: K=7, rate-1/4 mother code.

ETSI EN 300 401 clause 11.1: generator polynomials (octal) 133, 171, 145, 133.
Parity surface: reference src/dab/algorithms/dab_viterbi_decoder.{h,cpp} and
the vendored ViterbiDecoderCpp (soft bits int8 in [-127,+127], punctured
positions fed as 0, add-compare-select over 64 states, chainback to state 0).

Accelerator design (SURVEY.md §7): instead of SIMD lanes over one stream, the decoder
is a `lax.scan` over trellis steps whose per-step add-compare-select is a pure
reshape/min butterfly over the 64-state axis (no gathers), vmapped over a batch
axis (subchannels x ensembles). Depuncturing is a precomputed static gather.

State convention: state s after consuming bit a(t) is the 6 most recent input
bits with a(t) at bit 5: s_t = [a(t) a(t-1) ... a(t-5)]. The transition from
s with new input b is s' = (b << 5) | (s >> 1).
"""

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..params.puncture import build_depuncture_gather, CODE_RATE

K = 7
NB_STATES = 1 << (K - 1)
POLYS = (0o133, 0o171, 0o145, 0o133)
SOFT_HIGH = 127   # logical bit 1
SOFT_LOW = -127   # logical bit 0


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


@functools.lru_cache(maxsize=1)
def _expected_outputs() -> np.ndarray:
    """(64, 2, 4) int32: expected soft sign (+/-1) of each coded bit for a
    transition from state s with input b. Register = [b, s5..s0] where poly
    bit 6 taps the newest input bit."""
    s = np.arange(NB_STATES, dtype=np.int64)[:, None, None]
    b = np.arange(2, dtype=np.int64)[None, :, None]
    reg = (b << 6) | s
    polys = np.array(POLYS, dtype=np.int64)[None, None, :]
    bits = _parity(reg & polys)
    return (2 * bits - 1).astype(np.int32)   # bit -> +/-1


@functools.lru_cache(maxsize=1)
def _branch_sign_matrix() -> np.ndarray:
    """(4, 128) int32: negated expected signs laid out so that
    d_t(..., 4) @ S -> (..., 128) = branch error minus the per-step
    constant 4*127. Exact identity for int8 soft symbols (incl. punctured
    zeros): |d - 127*e| = 127 - e*d, so sum_r |d_r - 127 e_r| =
    508 - sum_r e_r d_r; the 508 shifts every candidate equally and drops
    out of the min/argmin. Column layout: s*2 + b (state-major)."""
    e = _expected_outputs()                  # (64, 2, 4)
    return np.ascontiguousarray(
        -e.reshape(NB_STATES * 2, CODE_RATE).T).astype(np.int32)


# per trellis step, the dropped constant (for reference-parity path error)
_STEP_ERR_OFFSET = CODE_RATE * SOFT_HIGH


@functools.lru_cache(maxsize=1)
def _branch_pattern_lut():
    """LUT factorization of the branch metrics: the 128 per-(state, bit)
    branch errors of one trellis step take only 16 distinct values
    (+/-d0 +/-d1 +/-d2 +/-d3), so instead of the (128, 4) @ (4, B) sign
    matmul (1024*B MACs/step) one can compute the 16 sums with a
    (16, 4) @ (4, B) matmul (64*B MACs) and expand with a static 128-row
    gather — the speed-of-light lever for the ACS step, whose ALU budget
    is dominated by the branch matmuls.

    Returns (idx (128,) int32, H (16, 4) f32) with
    _branch_sign_matrix().T[k, :] == H[idx[k], :] for every k."""
    S = _branch_sign_matrix().T                      # (128, 4), entries +/-1
    H = np.array([[1 - 2 * ((m >> i) & 1) for i in range(4)]
                  for m in range(16)], np.int64)     # (16, 4)
    bits = ((1 - S) // 2).astype(np.int64)           # (128, 4) in {0, 1}
    idx = (bits * (1 << np.arange(4))).sum(axis=1)
    assert (H[idx] == S).all()
    return idx.astype(np.int32), H.astype(np.float32)


def conv_encode(bits: np.ndarray, append_tail: bool = True) -> np.ndarray:
    """Encode 0/1 bits with the DAB mother code. Returns the serialized coded
    bit stream x0(0) x1(0) x2(0) x3(0) x0(1) ... as 0/1 uint8.
    With append_tail, six zero bits terminate the trellis at state 0."""
    bits = np.asarray(bits, dtype=np.uint8)
    if append_tail:
        bits = np.concatenate([bits, np.zeros(K - 1, dtype=np.uint8)])
    exp = (_expected_outputs() + 1) // 2     # back to 0/1, (64, 2, 4)
    out = np.empty((bits.shape[0], CODE_RATE), dtype=np.uint8)
    state = 0
    for t, b in enumerate(bits.tolist()):
        out[t] = exp[state, b]
        state = (b << 5) | (state >> 1)
    return out.reshape(-1)


def puncture(coded: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Keep only transmitted mother symbols (TX side)."""
    return coded[mask]


def bits_to_soft(bits: np.ndarray) -> np.ndarray:
    """0/1 bits -> ideal int8 soft symbols (+127 for 1, -127 for 0)."""
    return np.where(np.asarray(bits) > 0, SOFT_HIGH, SOFT_LOW).astype(np.int8)


@dataclass(frozen=True)
class ViterbiSpec:
    """Static decode plan for one puncture schedule."""
    gather_idx: np.ndarray     # (nb_mother,) int32 into the received stream
    mask: np.ndarray           # (nb_mother,) bool, True where transmitted
    nb_in: int                 # transmitted symbols consumed
    nb_steps: int              # trellis steps = nb_mother / 4
    nb_data_bits: int          # decoded bits excluding the 6 tail bits

    @classmethod
    def from_schedule(cls, schedule) -> "ViterbiSpec":
        idx, mask, nb_in = build_depuncture_gather(schedule)
        nb_steps = mask.shape[0] // CODE_RATE
        return cls(idx, mask, nb_in, nb_steps, nb_data_bits=nb_steps - (K - 1))


def depuncture(rx_soft: jnp.ndarray, spec: ViterbiSpec) -> jnp.ndarray:
    """(..., nb_in) int8 -> (..., nb_steps, 4) int32 with zeros at punctured
    positions (zero soft symbols are metric-neutral)."""
    idx = jnp.asarray(spec.gather_idx)
    mask = jnp.asarray(spec.mask)
    d = jnp.where(mask, rx_soft[..., idx], 0)
    return d.astype(jnp.int32).reshape(*rx_soft.shape[:-1], spec.nb_steps, CODE_RATE)


def _acs_step(pm, branch_err):
    """One add-compare-select butterfly.

    pm: (..., 64) path metrics. branch_err: (..., 64, 2) branch error for each
    (state, input-bit). New state s' = (b<<5)|(s>>1); its two predecessors are
    2j and 2j+1 where j = s' & 31, both with input b = s' >> 5.
    Returns (new_pm (...,64), decision (...,64) uint8)."""
    cand = pm[..., :, None] + branch_err                      # (..., 64, 2)
    pairs = cand.reshape(*cand.shape[:-2], 32, 2, 2)          # (..., j, p, b)
    new_pm_jb = jnp.min(pairs, axis=-2)                       # (..., j, b)
    dec_jb = jnp.argmin(pairs, axis=-2).astype(jnp.uint8)     # (..., j, b)
    # state layout s' = b*32 + j  ->  transpose (j, b) -> (b, j)
    new_pm = jnp.swapaxes(new_pm_jb, -1, -2).reshape(*pm.shape[:-1], NB_STATES)
    dec = jnp.swapaxes(dec_jb, -1, -2).reshape(*pm.shape[:-1], NB_STATES)
    return new_pm, dec


_INITIAL_NON_START = 5 * CODE_RATE * (SOFT_HIGH - SOFT_LOW)   # reference error margin


def viterbi_decode_soft(depunctured: jnp.ndarray, start_state: int = 0,
                        end_state: int = 0):
    """Decode (..., T, 4) int32 depunctured soft symbols.

    Returns (bits (..., T) int8 of 0/1 including tail, path_error (...,) int32).
    Fully jit-compatible; batch dims broadcast through.
    """
    S = jnp.asarray(_branch_sign_matrix())                    # (4, 128)
    T = depunctured.shape[-2]
    batch_shape = depunctured.shape[:-2]

    pm0 = jnp.full((*batch_shape, NB_STATES), _INITIAL_NON_START, dtype=jnp.int32)
    pm0 = pm0.at[..., start_state].set(0)

    # scan over trellis steps; xs leading axis must be time
    xs = jnp.moveaxis(depunctured, -2, 0)                     # (T, ..., 4)

    def step(pm, d_t):
        # branch error as one sign-correlation matmul (see
        # _branch_sign_matrix); the dropped 508/step constant is restored
        # on the returned path error below
        branch_err = (d_t @ S).reshape(*d_t.shape[:-1], NB_STATES, 2)
        new_pm, dec = _acs_step(pm, branch_err)
        return new_pm, dec

    pm_final, decisions = jax.lax.scan(step, pm0, xs)         # decisions (T, ..., 64)

    # chainback from end_state
    def back(state, dec_t):
        bit = (state >> 5).astype(jnp.int8)
        d = jnp.take_along_axis(dec_t, state[..., None].astype(jnp.int32),
                                axis=-1)[..., 0]
        prev = ((state & 31) << 1) | d.astype(state.dtype)
        return prev, bit

    state0 = jnp.full(batch_shape, end_state, dtype=jnp.int32)
    _, bits_rev = jax.lax.scan(back, state0, decisions, reverse=True)
    bits = jnp.moveaxis(bits_rev, 0, -1)                      # (..., T)
    error = pm_final[..., end_state] + T * _STEP_ERR_OFFSET
    return bits, error


def _radix4_forward_sm(pm0, xs, branch: str = "matmul"):
    """State-major radix-4 forward pass.

    pm0: (64, B) f32. xs: (T/2, 2, B, 4) f32. Returns (pm (64, B),
    decisions (T/2, 64, B) uint8).

    Layout note: the batch axis is minor-most, so every (64, B) array is
    contiguous along the lanes (B) and each state row is one coalesced
    vector.

    branch="lut" computes the 16 distinct +/-d sums with a (16, 4)
    matmul and expands them with a static gather instead of the (128, 4)
    sign matmul — 16x fewer branch MACs, bit-identical metrics
    (_branch_pattern_lut); an A/B lever for the ACS step.

    Precision: the branch products are f32 matmuls at JAX's default
    precision, which on a GPU may run in TF32 (10 explicit mantissa bits).
    They stay exact: every operand is a +/-1 sign or an integer soft
    symbol with |d| <= 127, which TF32 represents exactly, and the f32
    accumulation of at most four products of magnitude <= 127 is exact."""
    St = jnp.asarray(_branch_sign_matrix().T).astype(jnp.float32)  # (128, 4)
    B = pm0.shape[-1]

    if branch == "lut":
        idx16, H16 = _branch_pattern_lut()
        Hj = jnp.asarray(H16)                          # (16, 4)
        idxj = jnp.asarray(idx16)                      # (128,)

        def branch_err(d_t):
            # +/-1 @ |d| <= 127: exact even in TF32 (see docstring)
            v = Hj @ d_t.T                             # (16, B)
            return v[idxj].reshape(NB_STATES, 2, B)
    else:
        def branch_err(d_t):
            # (128, 4) @ (4, B) -> (128, B) = (s*2+b, B), state-major;
            # +/-1 @ |d| <= 127: exact even in TF32 (see docstring)
            return (St @ d_t.T).reshape(NB_STATES, 2, B)

    # packed min+argmin: ONE min reduction yields both the survivor metric
    # (floor-divide by 4) and the decision (remainder), with first-minimum-
    # wins tie-breaking preserved (smallest p among equal metrics) — half
    # the reduction work of separate min + argmin. Exactness needs
    # |4*m + p| < 2^24, but absolute path metrics drift by up to
    # +/-1016/iteration (T reaches 9222+ steps for high-bitrate
    # subchannels), so metrics are REBASED each step: subtracting new_pm[0]
    # from every state shifts all of the next step's candidates equally
    # (min/argmin and ties unchanged) and bounds the carried values by the
    # state-metric spread, <= (K-1)*1016 + the initial offset ~ 12k.
    # The running base is carried separately (plain f32 adds, exact to
    # 2^24 ~ 33000 steps) and restored after the scan for the path error.
    p_idx = jnp.arange(4, dtype=jnp.float32)[None, :, None, None, None]

    def step(carry, d2):
        pm, base = carry
        bm_a = branch_err(d2[0])                      # (s0, b1, B)
        bm_b = branch_err(d2[1])                      # (s1, b2, B)
        # remap bm_b onto (s0, b1, b2): s1 = (b1 << 5) | (s0 >> 1)
        tmp = bm_b.reshape(2, 32, 2, B)               # (b1, s0>>1, b2, B)
        tmp = jnp.broadcast_to(tmp[:, :, None], (2, 32, 2, 2, B))
        bmb = jnp.moveaxis(tmp, 0, 2)                 # (s0>>1, par, b1, b2, B)
        bmb = bmb.reshape(NB_STATES, 2, 2, B)         # (s0, b1, b2, B)
        cand = (pm[:, None, None, :] + bm_a[:, :, None, :] + bmb)
        quads = cand.reshape(16, 4, 2, 2, B)          # (j, p, b1, b2, B)
        packed = jnp.min(quads * 4.0 + p_idx, axis=1)  # (j, b1, b2, B)
        new_pm = jnp.floor(packed * 0.25)
        dec = (packed - 4.0 * new_pm).astype(jnp.uint8)
        # s2 = (b2 << 5) | (b1 << 4) | j -> order (b2, b1, j)
        new_pm = jnp.moveaxis(new_pm, (0, 1, 2), (2, 1, 0)
                              ).reshape(NB_STATES, B)
        dec = jnp.moveaxis(dec, (0, 1, 2), (2, 1, 0)).reshape(NB_STATES, B)
        rebase = new_pm[0]                            # (B,)
        return (new_pm - rebase[None, :], base + rebase), dec

    (pm, base), decisions = jax.lax.scan(
        step, (pm0, jnp.zeros(pm0.shape[1:], pm0.dtype)), xs)
    return pm + base[None, :], decisions


def _radix4_chainback_sm(decisions, state0):
    """decisions (T/2, 64, B) uint8, state0 (B,) int32 ->
    bits (T, B) int8 (forward time order).

    The per-step state lookup is a one-hot select (compare + where + sum
    over the 64-state axis) instead of a gather, so the step is one fused
    elementwise + reduction kernel."""
    iota = jnp.arange(NB_STATES, dtype=jnp.int32)[:, None]

    def back(state, dec_t):
        b2 = (state >> 5).astype(jnp.int8)
        b1 = ((state >> 4) & 1).astype(jnp.int8)
        onehot = iota == state[None, :]
        p = jnp.sum(jnp.where(onehot, dec_t, 0), axis=0,
                    dtype=jnp.int32)                  # (B,)
        prev = ((state & 15) << 2) | p
        return prev, jnp.stack([b1, b2])              # (2, B), time order

    _, bits_rev = jax.lax.scan(back, state0, decisions, reverse=True)
    T2, _, B = decisions.shape
    return bits_rev.reshape(2 * T2, B)


def _chainback_parallel_sm(decisions, state0, radix_bits: int):
    """Log-depth chainback: compose the per-step traceback pointer maps with
    an associative scan instead of walking them sequentially.

    decisions: (Tr, 64, B) uint8 ancestor indices from a state-major forward
    pass of radix 2**radix_bits; state0: (B,) int32 traceback anchors.
    Returns bits (Tr*radix_bits, B) int8 in forward time order —
    bit-identical to the sequential chainback (pointer composition is pure
    index algebra; no arithmetic, no ties).

    Each step's traceback is a map over the 64 states,
    prev = ((s & (2^(6-r)-1)) << r) | dec[s]; the walk s_t = ptr_t(s_{t+1})
    is a suffix composition H_t = ptr_t . ptr_{t+1} . ... . ptr_{Tr-1}
    evaluated at the anchor. `lax.associative_scan` over map composition
    (compose(a, b)[s] = a[b[s]], one take_along_axis per node) computes all
    H_t in O(log Tr) sequential depth at O(Tr log Tr) gather work — the
    lever for the latency-bound fused serving round, where the Viterbi
    batch is small and scan iterations, not FLOPs, bound the round. For the
    throughput regime (B >= 4096) the
    sequential chainback's O(Tr) work wins; callers choose via
    `chainback=`."""
    Tr, S, B = decisions.shape
    r = radix_bits
    keep = (1 << (6 - r)) - 1
    iota = jnp.arange(S, dtype=jnp.int32)[None, :, None]
    ptr = ((iota & keep) << r) | decisions.astype(jnp.int32)    # (Tr, 64, B)

    def compose(a, b):
        # reverse=True feeds LATER elements as `a`: combine to (b . a),
        # i.e. earlier map applied outside — result[s] = b[a[s]]
        return jnp.take_along_axis(b, a, axis=-2)

    H = jax.lax.associative_scan(compose, ptr, reverse=True, axis=0)
    anchor = jnp.broadcast_to(
        state0.astype(jnp.int32)[None, None, :], (Tr, 1, B))
    s = jnp.take_along_axis(H, anchor, axis=1)[:, 0, :]         # s_t, (Tr, B)
    s_next = jnp.concatenate(
        [s[1:], state0.astype(jnp.int32)[None, :]], axis=0)     # s_{t+1}
    # newest input bit sits at register bit 5: step t emits bits (6-r)..5
    # of s_{t+1} in time order
    shifts = jnp.arange(6 - r, 6, dtype=jnp.int32)[:, None]     # (r, 1)
    bits = ((s_next[:, None, :] >> shifts) & 1).astype(jnp.int8)
    return bits.reshape(Tr * r, B)


def _radix4_forward_re(pm0, xs, branch: str = "matmul"):
    """Chainback-FREE radix-4 forward pass: register exchange.

    Every state carries its decoded bit history as packed uint32 words;
    each ACS step selects the survivor predecessor's history (a 4-way
    select over STATIC state permutations — no dynamic gathers) and
    appends the two bits implied by the new state index (in register
    exchange the appended bits are a static property of the destination
    state: s' = (b2<<5)|(b1<<4)|j). The traceback scan disappears
    entirely — sequential depth is the ACS scan alone, the last lever
    class left after radix-4 + tiled + parallel chainback.

    Work trade: O(T^2/32) word-selects vs chainback's O(T), so this is
    for SHORT trellises where scan depth, not word volume, bounds the
    round — the tiled decoder's fixed L=chunk+2*overlap window (W =
    L/16 words) and FIC-sized groups. Exactness: survivor selection is
    the identical packed-min ACS, so bits match the sequential
    chainback bit-for-bit, ties included.

    pm0: (64, B) f32. xs: (T/2, 2, B, 4) f32, T/2 <= 2^16.
    Returns (pm (64, B), hist (64, B, W) uint32) with bit 2t+k of the
    stream at word (2t+k)>>5, bit position (2t+k)&31 (LSB-first).

    branch: same "matmul"/"lut" routes as _radix4_forward_sm — identical
    metrics either way, so the fused chainback composes with the LUT
    roofline lever instead of silently dropping it."""
    St = jnp.asarray(_branch_sign_matrix().T).astype(jnp.float32)  # (128, 4)
    B = pm0.shape[-1]
    T2 = xs.shape[0]
    W = -(-(2 * T2) // 32)

    if branch == "lut":
        idx16, H16 = _branch_pattern_lut()
        Hj = jnp.asarray(H16)                          # (16, 4)
        idxj = jnp.asarray(idx16)                      # (128,)

        def branch_err(d_t):
            return (Hj @ d_t.T)[idxj].reshape(NB_STATES, 2, B)
    else:
        def branch_err(d_t):
            return (St @ d_t.T).reshape(NB_STATES, 2, B)

    p_idx = jnp.arange(4, dtype=jnp.float32)[None, :, None, None, None]
    # static predecessor permutations: pred_p[s'] = ((s' & 15) << 2) | p
    sp = np.arange(NB_STATES)
    perms = [((sp & 15) << 2) | p for p in range(4)]
    # bits appended at state s': b1 = (s'>>4)&1 (older), b2 = s'>>5
    new2 = jnp.asarray(((sp >> 4) & 1) | ((sp >> 5) << 1),
                       jnp.uint32)[:, None]            # (64, 1)

    def step(carry, inp):
        pm, base, hist = carry
        d2, t = inp
        bm_a = branch_err(d2[0])
        bm_b = branch_err(d2[1])
        tmp = jnp.broadcast_to(bm_b.reshape(2, 32, 2, B)[:, :, None],
                               (2, 32, 2, 2, B))
        bmb = jnp.moveaxis(tmp, 0, 2).reshape(NB_STATES, 2, 2, B)
        cand = (pm[:, None, None, :] + bm_a[:, :, None, :] + bmb)
        quads = cand.reshape(16, 4, 2, 2, B)
        packed = jnp.min(quads * 4.0 + p_idx, axis=1)
        new_pm = jnp.floor(packed * 0.25)
        dec = (packed - 4.0 * new_pm).astype(jnp.uint8)
        new_pm = jnp.moveaxis(new_pm, (0, 1, 2), (2, 1, 0)
                              ).reshape(NB_STATES, B)
        dec = jnp.moveaxis(dec, (0, 1, 2), (2, 1, 0)
                           ).reshape(NB_STATES, B)[..., None]  # (64, B, 1)
        # survivor history: 4-way select over static permutations
        nh = jnp.where(dec == 0, hist[perms[0]],
                       jnp.where(dec == 1, hist[perms[1]],
                                 jnp.where(dec == 2, hist[perms[2]],
                                           hist[perms[3]])))
        # append the 2 new bits into word (2t)>>5 at bit (2t)&31
        word = (2 * t) >> 5
        shift = ((2 * t) & 31).astype(jnp.uint32)
        upd = jax.lax.dynamic_slice_in_dim(nh, word, 1, axis=2)
        upd = upd | (new2[:, :, None] << shift)
        nh = jax.lax.dynamic_update_slice_in_dim(nh, upd, word, axis=2)
        rebase = new_pm[0]
        return (new_pm - rebase[None, :], base + rebase, nh), None

    hist0 = jnp.zeros((NB_STATES, B, W), jnp.uint32)
    ts = jnp.arange(T2, dtype=jnp.int32)
    (pm, base, hist), _ = jax.lax.scan(
        step, (pm0, jnp.zeros(pm0.shape[1:], pm0.dtype), hist0), (xs, ts))
    return pm + base[None, :], hist


def _re_extract_bits(hist, state0, T: int):
    """hist (64, B, W) uint32 from _radix4_forward_re, state0 (B,) anchor
    states -> bits (T, B) int8 in forward time order."""
    B = hist.shape[1]
    h = jnp.take_along_axis(
        hist, state0.astype(jnp.int32)[None, :, None], axis=0)[0]  # (B, W)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = ((h[:, :, None] >> shifts) & 1).astype(jnp.int8)        # (B, W, 32)
    return jnp.moveaxis(bits.reshape(B, -1)[:, :T], 0, 1)          # (T, B)


def _radix8_forward_sm(pm0, xs):
    """State-major radix-8 forward pass: THREE trellis steps fused per
    scan iteration (sequential depth T/3 vs T/2 for radix-4; the scans are
    the latency bound).

    pm0: (64, B) f32. xs: (T/3, 3, B, 4) f32. Returns (pm (64, B),
    decisions (T/3, 64, B) uint8 — 3-bit ancestor index)."""
    St = jnp.asarray(_branch_sign_matrix().T).astype(jnp.float32)  # (128, 4)
    B = pm0.shape[-1]

    def branch_err(d_t):
        return (St @ d_t.T).reshape(NB_STATES, 2, B)

    def step(carry, d3):
        pm, base = carry
        bm_a = branch_err(d3[0])                      # (s0, b1, B)
        bm_b = branch_err(d3[1])                      # (s1, b2, B)
        bm_c = branch_err(d3[2])                      # (s2, b3, B)
        # s1 = (b1<<5)|(s0>>1): remap onto (s0, b1, b2)
        t2 = jnp.broadcast_to(bm_b.reshape(2, 32, 2, B)[:, :, None],
                              (2, 32, 2, 2, B))      # (b1, s0>>1, par, b2, B)
        bmb = jnp.moveaxis(t2, 0, 2).reshape(NB_STATES, 2, 2, B)
        # s2 = (b2<<5)|(b1<<4)|(s0>>2): remap onto (s0, b1, b2, b3)
        t3 = jnp.broadcast_to(
            bm_c.reshape(2, 2, 16, 1, 2, B),
            (2, 2, 16, 4, 2, B))                     # (b2, b1, hi, par2, b3, B)
        bmc = jnp.moveaxis(t3, (0, 1), (3, 2)
                           ).reshape(NB_STATES, 2, 2, 2, B)
        cand = (pm[:, None, None, None, :]
                + bm_a[:, :, None, None, :]
                + bmb[:, :, :, None, :] + bmc)       # (s0, b1, b2, b3, B)
        # final s3 = (b3<<5)|(b2<<4)|(b1<<3)|(s0>>3); candidates ordered by
        # p = s0 & 7 = 4*p3 + 2*p2 + p1 — lexicographic (latest step major)
        # first-min-wins reproduces the sequential per-step even-
        # predecessor tie-breaks (same argument as radix-4, one level up).
        # packed min+argmin in one reduction with per-step rebasing — the
        # same exactness argument as _radix4_forward_sm (rebased metrics
        # stay within the ~12k state spread, so |8*m + p| << 2^24)
        octs = cand.reshape(8, 8, 2, 2, 2, B)        # (oct, p, b1, b2, b3, B)
        p_idx = jnp.arange(8, dtype=jnp.float32)[None, :, None, None, None,
                                                 None]
        packed = jnp.min(octs * 8.0 + p_idx, axis=1)  # (oct, b1, b2, b3, B)
        new_pm = jnp.floor(packed * 0.125)
        dec = (packed - 8.0 * new_pm).astype(jnp.uint8)
        new_pm = jnp.moveaxis(new_pm, (0, 1, 2, 3), (3, 2, 1, 0)
                              ).reshape(NB_STATES, B)
        dec = jnp.moveaxis(dec, (0, 1, 2, 3), (3, 2, 1, 0)
                           ).reshape(NB_STATES, B)
        rebase = new_pm[0]                            # (B,)
        return (new_pm - rebase[None, :], base + rebase), dec

    (pm, base), decisions = jax.lax.scan(
        step, (pm0, jnp.zeros(pm0.shape[1:], pm0.dtype)), xs)
    return pm + base[None, :], decisions


def _radix8_chainback_sm(decisions, state0):
    """decisions (T/3, 64, B) uint8, state0 (B,) int32 ->
    bits (T, B) int8 (forward time order)."""
    iota = jnp.arange(NB_STATES, dtype=jnp.int32)[:, None]

    def back(state, dec_t):
        b3 = (state >> 5).astype(jnp.int8)
        b2 = ((state >> 4) & 1).astype(jnp.int8)
        b1 = ((state >> 3) & 1).astype(jnp.int8)
        onehot = iota == state[None, :]
        p = jnp.sum(jnp.where(onehot, dec_t, 0), axis=0, dtype=jnp.int32)
        prev = ((state & 7) << 3) | p
        return prev, jnp.stack([b1, b2, b3])          # (3, B), time order

    _, bits_rev = jax.lax.scan(back, state0, decisions, reverse=True)
    T3, _, B = decisions.shape
    return bits_rev.reshape(3 * T3, B)


def viterbi_decode_soft_radix8(depunctured: jnp.ndarray, start_state: int = 0,
                               end_state: int = 0,
                               chainback: str = "sequential"):
    """Radix-8 decode: three trellis steps per scan iteration. Bit-exact
    vs viterbi_decode_soft / _radix4 including argmin tie-breaking (see
    _radix8_forward_sm). Requires T % 3 == 0."""
    T = depunctured.shape[-2]
    assert T % 3 == 0, "radix-8 needs T divisible by 3"
    batch_shape = depunctured.shape[:-2]
    B = int(np.prod(batch_shape)) if batch_shape else 1

    d = depunctured.reshape(B, T, CODE_RATE).astype(jnp.float32)
    xs = jnp.moveaxis(d, 1, 0).reshape(T // 3, 3, B, CODE_RATE)
    pm0 = jnp.full((NB_STATES, B), _INITIAL_NON_START, jnp.float32)
    pm0 = pm0.at[start_state].set(0.0)

    pm_final, decisions = _radix8_forward_sm(pm0, xs)
    state0 = jnp.full((B,), end_state, jnp.int32)
    if chainback == "parallel":
        bits = _chainback_parallel_sm(decisions, state0, 3)   # (T, B)
    else:
        bits = _radix8_chainback_sm(decisions, state0)        # (T, B)
    bits = jnp.moveaxis(bits, 0, -1).reshape(*batch_shape, T)
    error = (pm_final[end_state] + T * _STEP_ERR_OFFSET
             ).astype(jnp.int32).reshape(batch_shape)
    return bits, error


def viterbi_decode_soft_radix4(depunctured: jnp.ndarray, start_state: int = 0,
                               end_state: int = 0,
                               chainback: str = "sequential",
                               branch: str = "matmul"):
    """Radix-4 decode: two trellis steps fused per scan iteration, halving
    the sequential depth (each scan iteration is at least one kernel
    launch on a GPU, and per-step tensors are tiny), in the state-major (64, B) layout (see
    _radix4_forward_sm). Bit-exact vs viterbi_decode_soft including argmin
    tie-breaking: candidates are ordered by p = s0 & 3 = (p_step2 << 1) |
    p_step1, and first-minimum-wins over that order reproduces the
    sequential even-predecessor-first preference at both steps. Metrics are
    f32 (exact: correlation sums stay far below 2^24).

    chainback="parallel" swaps the traceback walk for the log-depth map
    composition (_chainback_parallel_sm) — same bits, O(log T) sequential
    depth; use when the batch is small and scan latency dominates.

    Requires an even number of trellis steps (always true for DAB: byte
    payloads + 6 tail bits)."""
    T = depunctured.shape[-2]
    assert T % 2 == 0, "radix-4 needs an even trellis length"
    batch_shape = depunctured.shape[:-2]
    B = int(np.prod(batch_shape)) if batch_shape else 1

    d = depunctured.reshape(B, T, CODE_RATE).astype(jnp.float32)
    xs = jnp.moveaxis(d, 1, 0).reshape(T // 2, 2, B, CODE_RATE)
    pm0 = jnp.full((NB_STATES, B), _INITIAL_NON_START, jnp.float32)
    pm0 = pm0.at[start_state].set(0.0)

    state0 = jnp.full((B,), end_state, jnp.int32)
    if chainback == "fused":
        pm_final, hist = _radix4_forward_re(pm0, xs, branch=branch)
        bits = _re_extract_bits(hist, state0, T)              # (T, B)
    else:
        pm_final, decisions = _radix4_forward_sm(pm0, xs, branch=branch)
        if chainback == "parallel":
            bits = _chainback_parallel_sm(decisions, state0, 2)   # (T, B)
        else:
            bits = _radix4_chainback_sm(decisions, state0)        # (T, B)
    bits = jnp.moveaxis(bits, 0, -1).reshape(*batch_shape, T)
    error = (pm_final[end_state] + T * _STEP_ERR_OFFSET
             ).astype(jnp.int32).reshape(batch_shape)
    return bits, error


def viterbi_decode_soft_tiled(depunctured: jnp.ndarray,
                              chunk: int = 128, overlap: int = 96,
                              chainback: str = "sequential",
                              branch: str = "matmul"):
    """Overlap-save tiled decode: the T trellis steps split into chunks that
    decode in parallel, each with `overlap` warmup steps (ACS from uniform
    metrics converges to the survivor paths within ~5-10 constraint lengths)
    and `overlap` cooldown steps before its traceback anchor.

    Sequential depth drops from T to chunk + 2*overlap at ~(1 + 2*overlap/
    chunk)x the FLOPs — the standard high-throughput Viterbi structure
    (the reference decodes each message serially: dab_viterbi_decoder.cpp).
    Not guaranteed bit-exact under extreme noise (the per-layer CRCs gate
    such frames anyway); exact on clean input and equal to the full decode
    at operating SNR (tests/test_viterbi.py).

    depunctured: (B, T, 4) int32. Returns (bits (B, T) int8, None)."""
    assert depunctured.ndim == 3, "tiled path expects one batch dim"
    B, T, _ = depunctured.shape
    assert chunk % 2 == 0 and overlap % 2 == 0
    nb_chunks = -(-T // chunk)
    Tp = nb_chunks * chunk
    L = chunk + 2 * overlap                       # extended chunk length

    # neutral (zero) branch symbols outside [0, T)
    d_pad = jnp.pad(depunctured, ((0, 0), (overlap, Tp - T + overlap), (0, 0)))
    starts = jnp.arange(nb_chunks) * chunk        # into d_pad
    idx = starts[:, None] + jnp.arange(L)[None, :]
    chunks = d_pad[:, idx]                        # (B, C, L, 4)
    BC = B * nb_chunks
    x = chunks.reshape(BC, L, CODE_RATE).astype(jnp.float32)

    # chunk 0 starts from the true state-0 init; others from uniform metrics
    pm0_first = jnp.full((NB_STATES,), _INITIAL_NON_START, jnp.float32
                         ).at[0].set(0.0)
    pm0_rest = jnp.zeros((NB_STATES,), jnp.float32)
    pm0 = jnp.where((jnp.arange(nb_chunks) == 0)[None, :],
                    pm0_first[:, None], pm0_rest[:, None])     # (64, C)
    pm0 = jnp.broadcast_to(pm0[:, None, :], (NB_STATES, B, nb_chunks)
                           ).reshape(NB_STATES, BC)

    xs = jnp.moveaxis(x, 1, 0).reshape(L // 2, 2, BC, CODE_RATE)
    if chainback == "fused":
        # register exchange: no traceback scan at all — sequential depth
        # is the L/2 ACS iterations alone (W = L/32 words per state stays
        # small because the tile length is fixed)
        pm_final, hist = _radix4_forward_re(pm0, xs, branch=branch)
        state0 = jnp.argmin(pm_final, axis=0).astype(jnp.int32)
        bits = _re_extract_bits(hist, state0, L)              # (L, BC)
    else:
        pm_final, decisions = _radix4_forward_sm(pm0, xs,
                                                 branch=branch)
        state0 = jnp.argmin(pm_final, axis=0).astype(jnp.int32)   # (BC,)
        if chainback == "parallel":
            bits = _chainback_parallel_sm(decisions, state0, 2)   # (L, BC)
        else:
            bits = _radix4_chainback_sm(decisions, state0)        # (L, BC)
    bits = jnp.moveaxis(bits, 0, -1)                          # (BC, L)
    bits = bits.reshape(B, nb_chunks, L)[:, :, overlap:overlap + chunk]
    return bits.reshape(B, Tp)[:, :T], None


def viterbi_decode(rx_soft: jnp.ndarray, spec: ViterbiSpec,
                   chainback: str = "sequential", branch: str = "matmul"):
    """End-to-end: depuncture + decode + drop tail bits.

    rx_soft: (..., nb_in) int8 soft symbols. Returns (data_bits (..., nb_data)
    int8, path_error (...,) int32)."""
    d = depuncture(rx_soft, spec)
    if spec.nb_steps % 2 == 0:
        bits, err = viterbi_decode_soft_radix4(d, chainback=chainback,
                                               branch=branch)
    else:
        bits, err = viterbi_decode_soft(d)
    nb_data = spec.nb_steps - (K - 1)
    return bits[..., :nb_data], err


def viterbi_decode_tiled(rx_soft: jnp.ndarray, spec: ViterbiSpec,
                         chunk: int = 128, overlap: int = 96,
                         chainback: str = "sequential"):
    """Tiled variant of viterbi_decode (latency-optimised; see
    viterbi_decode_soft_tiled for the accuracy contract)."""
    d = depuncture(rx_soft, spec)
    squeeze = d.ndim == 2
    if squeeze:
        d = d[None]
    bits, _ = viterbi_decode_soft_tiled(d, chunk=chunk, overlap=overlap,
                                        chainback=chainback)
    nb_data = spec.nb_steps - (K - 1)
    bits = bits[..., :nb_data]
    return (bits[0] if squeeze else bits), None


def pack_bits_msb(bits: np.ndarray) -> np.ndarray:
    """0/1 bit array -> uint8 bytes, MSB first (host side)."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1)
