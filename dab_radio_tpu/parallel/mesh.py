"""Device-mesh sharded receiver steps.

Axes:
  'ens'  - ensembles/streams (pure data parallel; the north-star metric is
           concurrent real-time ensembles per card, ROADMAP.md)
  'time' - time blocks within one stream (sequence parallel with a
           one-window halo from the right neighbor via lax.ppermute,
           replacing the reference's SignalFFT/WaitFFT halo threads,
           SURVEY.md §2.6.1)
  'sub'  - MSC subchannels (the reference's per-subchannel thread pool,
           vmapped and sharded)
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map

from ..models.demodulator import OFDMDemodulator, DemodCarry


def make_receiver_mesh(n_devices: int | None = None, axis_sizes=None) -> Mesh:
    """Factor the device count into ('ens', 'time', 'sub') axes.

    Policy: 'sub' and 'time' each take ONE factor of 2 when available — enough to
    exercise the subchannel sharding and the ppermute time halo — and
    everything else goes to 'ens', the embarrassingly-parallel axis the
    north-star metric scales along (concurrent ensembles). The cards of
    one host are joined all to all, so the factorization follows the
    algorithm alone.
    So n=8 -> (2,2,2), n=16 -> (4,2,2), n=4 -> (1,2,2), n=2 -> (1,1,2),
    odd/prime n -> (n,1,1). Pass axis_sizes to override.
    """
    devices = np.array(jax.devices())
    n = devices.size if n_devices is None else n_devices
    assert n > 0, "n_devices must be positive"
    devices = devices[:n]
    if axis_sizes is None:
        sub = 2 if n % 2 == 0 else 1
        time = 2 if (n // sub) % 2 == 0 else 1
        axis_sizes = (n // (sub * time), time, sub)
    assert int(np.prod(axis_sizes)) == n, (axis_sizes, n)
    return Mesh(devices.reshape(axis_sizes), ("ens", "time", "sub"))


def shard_demod_batch(demod: OFDMDemodulator, mesh: Mesh):
    """Data-parallel frame step: batch axis sharded over every mesh axis."""
    sh = NamedSharding(mesh, P(("ens", "time", "sub")))
    step = jax.jit(
        jax.vmap(demod._frame_step_impl),
        in_shardings=(sh, sh),
        out_shardings=(sh, sh),
    )
    return step, sh, sh


def make_timesharded_demod(demod: OFDMDemodulator, mesh: Mesh,
                           frames_per_shard: int,
                           block_tracking: bool = False):
    """Sequence-parallel streaming demod over the 'time' axis.

    Input iq: (B, T) with T = n_time * frames_per_shard * frame_samples,
    aligned so frame f starts at f*frame_samples. Each time shard demodulates
    its local frames with a lax.scan carry; the trailing window margin
    (window_len - frame_samples) comes from the right neighbor via ppermute.
    The GLOBALLY last frame's margin has no right neighbor: callers pass
    `tail` — the (B, halo, 2) samples that FOLLOW this block in the stream
    (i.e. the next block's head). With a zero tail, a positive fine-time
    offset (real RX/TX sample-clock drift) would read garbage for the last
    frame of every block. Returns a jitted fn (carry, iq, tail) ->
    (carry, bits, offsets) where carry has (B, n_time) leading dims (each
    shard tracks its own steady-state sync) and offsets (B, n_time, f_loc)
    are each frame's measured fine-time offset — the host's drift
    re-anchor signal (the window absorbs [-CP, +margin] of accumulated
    drift; a serving loop must advance its read grid by the reported
    offset before that span exhausts, FusedFleet.drift_correction).

    block_tracking=True is the serving fast path: all frames_per_shard
    frames demodulate as ONE vmap batch using the block-start sync state,
    and the carry advances once per block from the LAST frame's estimates
    (sync corrections no longer compound within a block — a K-times slower
    tracking loop, fine for locked steady state; the sequential scan is
    the exact default). This lifts the demod's effective FFT batch from B
    to B*K."""
    p = demod.params
    fs = p.nb_frame_samples
    halo = demod.window_len - fs
    n_time = mesh.shape["time"]
    f_loc = frames_per_shard

    def local_demod(carry, iq_local, tail_local):
        # iq_local: (B_loc, f_loc*fs, 2) f32 pairs after shard_map splits
        # 'time' (complex never crosses the host<->device boundary, ops/iq.py)
        axis = "time"
        right = [(i, (i - 1) % n_time) for i in range(n_time)]
        halo_samples = jax.lax.ppermute(iq_local[:, :halo], axis, right)
        idx = jax.lax.axis_index(axis)
        # last shard's margin comes from the caller-supplied stream tail
        # (the next block's head; replicated over 'time', tiny)
        halo_samples = jnp.where(idx == n_time - 1,
                                 tail_local, halo_samples)
        ext = jnp.concatenate([iq_local, halo_samples], axis=1)
        carry = jax.tree.map(lambda x: x[:, 0], carry)

        if block_tracking:
            B_loc = ext.shape[0]
            wins = jnp.stack(
                [jax.lax.dynamic_slice_in_dim(ext, f * fs, demod.window_len,
                                              1) for f in range(f_loc)],
                axis=1)                       # (B_loc, f_loc, win, 2)
            wins = wins.reshape(B_loc * f_loc, demod.window_len, 2)
            c_rep = jax.tree.map(
                lambda x: jnp.broadcast_to(
                    x[:, None], (B_loc, f_loc, *x.shape[1:])
                ).reshape(B_loc * f_loc, *x.shape[1:]), carry)
            c_out, out = jax.vmap(demod._frame_step_impl)(c_rep, wins)
            bits = out["bits"].reshape(B_loc, f_loc, -1)
            # desynced frames report 0 (= no correction): a noise-burst
            # frame's offset is argmax-over-junk and must never move the
            # host read grid (the dynamic path gates its pointer advance
            # on sync_ok the same way, demodulator.py)
            offs = jnp.where(out["sync_ok"], out["offset"], 0
                             ).reshape(B_loc, f_loc)
            carry = jax.tree.map(
                lambda x: x.reshape(B_loc, f_loc, *x.shape[1:])[:, -1],
                c_out)
        else:
            def step(c, f):
                win = jax.lax.dynamic_slice_in_dim(
                    ext, f * fs, demod.window_len, 1)
                c, out = jax.vmap(demod._frame_step_impl)(c, win)
                # sync_ok gate: see block_tracking branch
                return c, (out["bits"],
                           jnp.where(out["sync_ok"], out["offset"], 0))

            carry, (bits, offs) = jax.lax.scan(step, carry,
                                               jnp.arange(f_loc))
            bits = jnp.moveaxis(bits, 0, 1)        # (B_loc, f_loc, nbits)
            offs = jnp.moveaxis(offs, 0, 1)        # (B_loc, f_loc)
        carry = jax.tree.map(lambda x: x[:, None], carry)
        return carry, bits[:, None], offs[:, None]

    sharded = shard_map(
        local_demod, mesh=mesh,
        in_specs=(P("ens", "time"), P("ens", "time"), P("ens", None, None)),
        out_specs=(P("ens", "time"), P("ens", "time", None, None),
                   P("ens", "time", None)),
        check_vma=False,
    )

    jitted = jax.jit(sharded)

    def run(carry, iq, tail=None):
        if tail is None:        # end-of-stream: nothing follows the block
            tail = jnp.zeros((iq.shape[0], halo, 2), jnp.float32)
        return jitted(carry, iq, tail)

    run.halo = halo
    return run


def multichip_receiver_step(mesh: Mesh, transmission_mode: int = 2,
                            frames_per_shard: int = 1,
                            nb_subchannel_cu: int = 12,
                            subchannels_per_shard: int = 2,
                            ensembles_per_shard: int = 2,
                            ingest: str = "pairs",
                            subchannel_cfgs=None,
                            block_tracking: bool = False,
                            viterbi: str = "exact",
                            chainback: str = "sequential",
                            viterbi_branch: str = "matmul",
                            fuse_fic: bool = False,
                            stop_after: str = None):
    """Full end-to-end sharded receiver step: IQ in, decoded bits out.

    One jitted program over the ('ens','time','sub') mesh (the surface the
    reference covers with threads + a pool, basic_radio.cpp:41-65, here
    scaled across chips):

      demod (ens x time, ppermute halo)
        -> frame split (all-gather over 'time' via sharding constraint)
        -> FIC: depuncture + Viterbi + energy-dispersal descramble (ens)
        -> MSC: per-subchannel CIF slice (ens x sub) -> 16-CIF time
           deinterleave (explicit carry) -> depuncture + Viterbi ->
           descramble

    Returns (fn, example_args). fn(demod_carry, deint_hist, iq,
    tail=None) -> (demod_carry, deint_hist, outputs); `tail` is the next
    block's first fn.tail_samples samples (same format as iq) feeding the
    final frame's timing margin — omit only at end of stream. outputs has:
      fib_bits (B, F, n_groups, 768) descrambled FIB-group bits,
      msc_bits (B, S, F*nb_cifs, nb_data) descrambled subchannel payload
      bits (valid once the deinterleaver history is full - 16 CIFs).

    With subchannel_cfgs (a list of SubchannelConfig, mixed UEP/EEP-A/EEP-B
    shapes allowed) each subchannel uses its own start address and
    protection; everything is padded to the largest subchannel's shape so
    the whole mix still decodes in ONE sharded program: per-subchannel depuncture gathers carry a 3-state mask
    (transmitted / punctured-zero / trellis-pad) where the pad region feeds
    strong zero-bit symbols so every trellis terminates in state 0 at the
    common padded length. Without subchannel_cfgs, subchannel s occupies
    CUs [s*cu, (s+1)*cu) with identical EEP-A protection. Byte-level
    FIG/superframe parsing stays on host exactly as in the single-chip
    receiver (reference msc_decoder.cpp:77-154 dispatches per-subchannel
    UEP/EEP the same way, sequentially).

    viterbi="tiled" switches the MSC decode to the overlap-save tiled
    Viterbi (ops/viterbi.py:viterbi_decode_soft_tiled): sequential scan
    depth drops ~4.8x (chunk+2*overlap vs the full padded trellis) at
    ~2.5x the ACS FLOPs — the lever when the round is latency-bound on
    scan iterations rather than compute. Accuracy contract: identical to
    exact on clean input and at operating SNR; under extreme noise a
    tile may anchor on a wrong survivor (the byte layer's firecode/CRC/
    RS gates such frames either way). msc_err is not computed in tiled
    mode (zeros). FIC always decodes exact (its trellis is short).

    chainback="parallel" swaps every Viterbi traceback (FIC and MSC, both
    viterbi modes) for the log-depth map-composition chainback
    (ops/viterbi.py:_chainback_parallel_sm) — bit-identical, O(log T)
    sequential depth instead of O(T); composes with viterbi="tiled" for
    the lowest-latency round (forward depth chunk/2+overlap, traceback
    depth ~log2). chainback="fused" removes the traceback entirely
    (register exchange: packed decoded-bit words ride the forward ACS
    scan, ops/viterbi.py _radix4_forward_re) — bit-identical survivor
    selection, sequential depth = the ACS scan alone, at O(T/32) extra
    uint32 state per trellis state.

    fuse_fic=True folds the FIC groups into the MSC Viterbi batch as
    extra lanes: each FIC trellis (774 steps) is padded to the common MSC
    trellis length with the same strong-zero-bit trellis-pad symbols the
    heterogeneous-subchannel path already uses, so ONE decode scan covers
    FIC + every subchannel — the separate FIC forward pass + chainback
    (774 sequential iterations) disappear from the round (each scan
    iteration is at least one kernel launch). Identical
    output on any signal where the FIC trellis's own metric terminates
    near state 0 (i.e. whenever the FIB CRC could pass); under pure-noise
    input a padded decode may anchor differently — such FIBs fail CRC
    either way. With viterbi="tiled", FIC decodes tiled too (same
    accuracy contract as MSC). fic_err is reported on the standalone
    scale (the pad steps' error offset is subtracted).

    stop_after truncates the program after a pipeline prefix — the
    per-stage timing ablation for the fused serving round. One of
    {"ingest", "demod", "subs", "deint", "depunct", "acs"}; the truncated
    step returns (carry, deint_hist, {"digest": f32 scalar}) where the
    digest is a device reduction over the stage's full output (so XLA
    cannot dead-code the stage and fetching the scalar waits for it):
      ingest  - u8 -> f32 dequantize only
      demod   - + the time-sharded frame-scan demodulator
      subs    - + frame regather, FIC soft slice, per-subchannel CIF
                gather
      deint   - + the 16-CIF block deinterleaver push (hist advances)
      depunct - + padded depuncture gathers -> Viterbi lanes (incl. the
                fused-FIC lane build when fuse_fic)
      acs     - + the radix-4 forward ACS scan alone (exact mode; no
                chainback) — isolates the traceback's cost from the
                forward trellis
    Timing deltas between successive stages give the per-stage ms table
    (tools/bench_stages.py drives this).
    """
    from ..ops import viterbi as vit
    from ..ops.deinterleave import (make_gather_index,
                                    deinterleave_push_block, DEPTH)
    from ..ops.scrambler import prbs_bytes
    from ..params import (fic_puncture_schedule, msc_puncture_schedule,
                          SubchannelConfig, get_dab_params)

    if transmission_mode == 3:
        raise NotImplementedError(
            "transmission mode III FIC (32-CU FIB groups) is unsupported "
            "— the reference rejects it identically (fic_decoder.cpp:66-73)")
    # viterbi="radix8": three trellis steps per scan iteration (exact
    # incl. ties, ops/viterbi.py:viterbi_decode_soft_radix8) — the
    # iteration-count lever for serving lane counts where candidate
    # VOLUME is cheap but per-iteration fixed cost is not. Composes with sequential/parallel chainback
    # only, and only the matmul branch route (no LUT/fused variants —
    # asserted, not silently dropped).
    assert viterbi in ("exact", "tiled", "radix8"), viterbi
    assert chainback in ("sequential", "parallel", "fused"), chainback
    if viterbi == "radix8":
        assert chainback in ("sequential", "parallel"), \
            "radix8 has no register-exchange (fused) chainback"
    # viterbi_branch="lut": 16-entry branch-metric table instead of the
    # (128,4) matmul — bit-identical (ops/viterbi.py _branch_pattern_lut;
    # pinned by test_radix4_matches_radix2_exactly), an A/B lever for
    # the ACS step. Applies to every decode in the
    # round (FIC, MSC, fused lanes, exact and tiled).
    assert viterbi_branch in ("matmul", "lut"), viterbi_branch
    assert not (viterbi == "radix8" and viterbi_branch == "lut"), \
        "radix8 implements only the matmul branch route"
    demod = OFDMDemodulator(transmission_mode)
    dab = get_dab_params(transmission_mode)
    n_ens = mesh.shape["ens"]
    n_time = mesh.shape["time"]
    n_sub = mesh.shape["sub"]
    B = n_ens * ensembles_per_shard
    F = n_time * frames_per_shard
    C = F * dab.nb_cifs                             # CIFs per step
    demod_fn = make_timesharded_demod(demod, mesh, frames_per_shard,
                                      block_tracking=block_tracking)

    fic_spec = vit.ViterbiSpec.from_schedule(fic_puncture_schedule())
    if subchannel_cfgs is None:
        subchannel_cfgs = [
            SubchannelConfig(s * nb_subchannel_cu, nb_subchannel_cu, False,
                             eep_type="A", eep_prot_level=2)
            for s in range(n_sub * subchannels_per_shard)]
    cfgs = list(subchannel_cfgs)
    # per-STREAM heterogeneity: a list of per-ensemble cfg rows lets each
    # of the B streams monitor a DIFFERENT ensemble layout in the same
    # program (the 100-distinct-ensembles serving scenario); a flat list
    # shares one layout across streams (leaner static-slice path)
    per_stream = bool(cfgs) and isinstance(cfgs[0], (list, tuple))
    if per_stream:
        grid = [list(row) for row in cfgs]
        assert len(grid) == B, (len(grid), B)
        S = len(grid[0])
        assert all(len(row) == S for row in grid), "ragged cfg rows"
        flat = [c for row in grid for c in row]
    else:
        grid = [cfgs]
        S = len(cfgs)
        flat = cfgs
    assert S % n_sub == 0, (S, n_sub)
    spec_grid = [[vit.ViterbiSpec.from_schedule(msc_puncture_schedule(c))
                  for c in row] for row in grid]
    all_specs = [sp for row in spec_grid for sp in row]
    nb_sub_bits = max(c.nb_cif_bits for c in flat)   # padded common width
    # pad the common trellis length so data bits stay byte-aligned (device
    # packbits + host byte protocols: nb_data = 24k ≡ 0 mod 8) and the
    # step count divides by 2 (radix-4) AND 3 (radix-8): 6 + 24k. Costs
    # ≤ 16 extra strong-zero pad steps (<0.5% trellis) vs the old 6 + 8k;
    # the per-pad-step error-offset cancellation is count-independent
    # (see the fused-FIC note below)
    max_steps = max(s.nb_steps for s in all_specs)
    if fuse_fic:
        max_steps = max(max_steps, fic_spec.nb_steps)
    nb_steps = 6 + 24 * ((max_steps - 6 + 23) // 24)
    nb_data = nb_steps - 6
    gather_idx = jnp.asarray(make_gather_index(nb_sub_bits))
    assert all(c.start_address + c.length <= dab.nb_cif_bits // 64
               for c in flat), "subchannels exceed CIF capacity"

    # padded depuncture plan: value semantics of dmask — 1: transmitted
    # symbol (gather), 0: punctured (metric-neutral zero), -1: trellis pad
    # (strong zero-bit symbol keeps the survivor in state 0). Leading dims:
    # (S,) shared-layout, (B, S) per-stream.
    lead = (B, S) if per_stream else (S,)
    g_all = np.zeros(lead + (nb_steps * 4,), np.int32)
    m_all = np.full(lead + (nb_steps * 4,), -1, np.int8)
    msc_prbs_pad = np.zeros(lead + (nb_data,), np.int8)
    for bi, row in enumerate(spec_grid):
        for si, sp in enumerate(row):
            at = (bi, si) if per_stream else (si,)
            n_mother = sp.nb_steps * 4
            g_all[at][:n_mother] = sp.gather_idx
            m_all[at][:n_mother] = sp.mask.astype(np.int8)
            msc_prbs_pad[at][:sp.nb_data_bits] = np.unpackbits(
                prbs_bytes(sp.nb_data_bits // 8)).astype(np.int8)
    g_all = jnp.asarray(g_all)
    m_all = jnp.asarray(m_all)
    msc_prbs = jnp.asarray(msc_prbs_pad)
    nb_data_list = [[sp.nb_data_bits for sp in row] for row in spec_grid] \
        if per_stream else [sp.nb_data_bits for sp in all_specs]

    fic_prbs = jnp.asarray(np.unpackbits(
        prbs_bytes(fic_spec.nb_data_bits // 8)).astype(np.int8))

    sub_sh = NamedSharding(mesh, P("ens", "sub"))
    time_sh = NamedSharding(mesh, P("ens", "time"))
    assert stop_after in (None, "ingest", "demod", "subs", "deint",
                          "depunct", "acs"), stop_after

    def _digest(*xs):
        # full (not strided) reductions: every stage output is consumed
        # whole, so XLA cannot dead-code any part of the prefix; one HBM
        # pass per tensor (<1 ms at serving shapes) — negligible next to
        # the stages under measurement
        return sum(jnp.sum(x.astype(jnp.float32)) for x in xs)

    @jax.jit
    def step(carry, deint_hist, iq, tail=None):
        if ingest == "u8":
            # raw interleaved uint8 IQ -> f32 pairs on device (QuantisedIQ
            # convention); 4x less host->device traffic than f32 pairs
            iq = ((iq.astype(jnp.float32) - 127.5) * (1.0 / 127.5)
                  ).reshape(iq.shape[0], -1, 2)
            if tail is not None:
                tail = ((tail.astype(jnp.float32) - 127.5) * (1.0 / 127.5)
                        ).reshape(tail.shape[0], -1, 2)
        if stop_after == "ingest":
            return carry, deint_hist, {"digest": _digest(iq)}
        carry, bits, offs = demod_fn(carry, iq, tail)  # (B, n_time, f_loc, nb)
        if stop_after == "demod":
            return carry, deint_hist, {"digest": _digest(bits, offs)}
        # gather the time shards: frames are decoded ensemble-parallel
        frames = jax.lax.with_sharding_constraint(
            bits.reshape(B, F, dab.nb_frame_bits),
            NamedSharding(mesh, P("ens", None, None)))

        # ---- FIC (reference fic_decoder.cpp:53-117, batched) ----
        fic_soft = frames[:, :, :dab.nb_fic_bits].reshape(
            B * F * dab.nb_cifs, fic_spec.nb_in).astype(jnp.int8)
        if fuse_fic:
            # pad each FIC trellis to the common MSC length with strong
            # zero-bit symbols (state-0 extension, see docstring) and
            # decode it as extra lanes of the ONE MSC Viterbi scan below
            d_fic = vit.depuncture(fic_soft, fic_spec)
            d_fic = jnp.pad(
                d_fic, ((0, 0), (0, nb_steps - fic_spec.nb_steps), (0, 0)),
                constant_values=vit.SOFT_LOW)
            fib_bits = fic_err = None        # filled after the fused decode
        else:
            d_fic = None
            fib_bits, fic_err = vit.viterbi_decode(fic_soft, fic_spec,
                                                   chainback=chainback,
                                                   branch=viterbi_branch)
            fib_bits = (fib_bits ^ fic_prbs[None, :]).reshape(
                B, F, dab.nb_cifs, fic_spec.nb_data_bits)

        # ---- MSC (reference msc_decoder.cpp:46-154, sharded over 'sub') --
        cifs = frames[:, :, dab.nb_fic_bits:].reshape(
            B, C, dab.nb_cif_bits)
        if per_stream:
            # per-(stream, subchannel) CIF slices via one padded gather
            starts = np.array([[c.start_address * 64 for c in row]
                               for row in grid])            # (B, S)
            lens = np.array([[c.nb_cif_bits for c in row] for row in grid])
            j = np.arange(nb_sub_bits)
            idx = np.minimum(starts[..., None] + j, dab.nb_cif_bits - 1)
            valid = j[None, None, :] < lens[..., None]
            # vmap over the S axis gathering from the SHARED (B, C, bits)
            # cifs — no S-times-wider broadcast operand for XLA to
            # (potentially) materialize
            idx_bsj = jnp.asarray(idx)                  # (B, S, nb_sub_bits)

            def one_sub(ix):                            # ix: (B, nb_sub)
                return jnp.take_along_axis(
                    cifs, jnp.broadcast_to(ix[:, None], (B, C, nb_sub_bits)),
                    axis=-1)
            subs = jax.vmap(one_sub, in_axes=1, out_axes=1)(idx_bsj)
            subs = jnp.where(jnp.asarray(valid)[:, :, None, :], subs, 0)
        else:
            sub_slices = []
            for cfg_ in cfgs:
                lo = cfg_.start_address * 64
                sl = cifs[:, :, lo:lo + cfg_.nb_cif_bits]
                if cfg_.nb_cif_bits < nb_sub_bits:
                    sl = jnp.pad(sl, ((0, 0), (0, 0),
                                      (0, nb_sub_bits - cfg_.nb_cif_bits)))
                sub_slices.append(sl)
            subs = jnp.stack(sub_slices, axis=1)    # (B, S, C, nb_sub_bits)
        subs = jax.lax.with_sharding_constraint(
            subs.astype(jnp.int8),
            NamedSharding(mesh, P("ens", "sub", None, None)))
        # with fuse_fic the FIC lane build (depuncture+pad) rides the
        # depunct prefix; WITHOUT it the standalone FIC decode ran above,
        # so every truncated rung from here on must fold its outputs into
        # the digest or XLA dead-codes the whole FIC Viterbi out of the
        # ablation program (the serving default is fuse_fic=True either
        # way — this keeps the non-fused ablation honest too)
        fic_keep = () if fib_bits is None else (fib_bits, fic_err)
        if stop_after == "subs":
            return carry, deint_hist, {"digest": _digest(
                subs, fic_soft,
                *(fic_keep if d_fic is None else (d_fic,)))}

        def per_sub(hist, seq):
            # scan-free block push: one static gather for all C CIFs
            return deinterleave_push_block(hist, seq, gather_idx)

        deint_hist, deints = jax.vmap(jax.vmap(per_sub))(deint_hist, subs)
        if stop_after == "deint":
            return carry, deint_hist, {"digest": _digest(deints, *fic_keep)}
        # padded per-subchannel depuncture (3-state mask, see docstring)
        g_b = g_all[:, :, None, :] if per_stream else g_all[None, :, None, :]
        m_b = m_all[:, :, None, :] if per_stream else m_all[None, :, None, :]
        d = jnp.take_along_axis(
            deints.astype(jnp.int32),
            jnp.broadcast_to(g_b, (B, S, C, nb_steps * 4)), axis=-1)
        d = jnp.where(m_b == 1, d, jnp.where(m_b == 0, 0, vit.SOFT_LOW))
        lanes = d.reshape(B * S * C, nb_steps, 4)
        if fuse_fic:
            lanes = jnp.concatenate([lanes, d_fic], axis=0)
        if stop_after == "depunct":
            return carry, deint_hist, {"digest": _digest(lanes, *fic_keep)}
        if stop_after == "acs":
            # forward ACS only, exactly as viterbi_decode_soft_radix4
            # preps it (exact mode): the delta vs the full step is the
            # chainback + descramble tail
            L = lanes.shape[0]
            d_f = lanes.reshape(L, nb_steps, 4).astype(jnp.float32)
            xs = jnp.moveaxis(d_f, 1, 0).reshape(nb_steps // 2, 2, L, 4)
            pm0 = jnp.full((vit.NB_STATES, L), vit._INITIAL_NON_START,
                           jnp.float32).at[0].set(0.0)
            pm_final, decisions = vit._radix4_forward_sm(
                pm0, xs, branch=viterbi_branch)
            return carry, deint_hist, {
                "digest": _digest(pm_final, decisions, *fic_keep)}
        if viterbi == "tiled":
            bits_full, _ = vit.viterbi_decode_soft_tiled(
                lanes, chainback=chainback, branch=viterbi_branch)
            err_full = jnp.zeros((lanes.shape[0],), jnp.int32)
        elif viterbi == "radix8":
            bits_full, err_full = vit.viterbi_decode_soft_radix8(
                lanes, chainback=chainback)
        else:
            bits_full, err_full = vit.viterbi_decode_soft_radix4(
                lanes, chainback=chainback, branch=viterbi_branch)
        if fuse_fic:
            fic_rows = bits_full[B * S * C:]
            fib_bits = (fic_rows[:, :fic_spec.nb_data_bits]
                        ^ fic_prbs[None, :]).reshape(
                B, F, dab.nb_cifs, fic_spec.nb_data_bits)
            # already on the standalone-decode scale: each SOFT_LOW pad
            # step contributes -_STEP_ERR_OFFSET to the state-0 extension
            # path's metric, exactly cancelling the +_STEP_ERR_OFFSET the
            # error formula restores per step — verified numerically
            # (padded decode error == unpadded; an earlier build
            # re-subtracted the pad offset and drove fic_err far negative
            # whenever the MSC trellis outgrew the 774-step FIC trellis)
            fic_err = err_full[B * S * C:]
            bits_full = bits_full[:B * S * C]
            msc_err = err_full[:B * S * C]
        else:
            msc_err = err_full
        prbs_b = msc_prbs[:, :, None, :] if per_stream \
            else msc_prbs[None, :, None, :]
        msc_bits = bits_full[..., :nb_data].reshape(B, S, C, nb_data) \
            ^ prbs_b
        return carry, deint_hist, {
            "fib_bits": fib_bits, "msc_bits": msc_bits,
            "fic_err": fic_err, "msc_err": msc_err,
            # per-frame fine-time offsets: the host serving loop's
            # sample-clock drift re-anchor signal (frame order = stream
            # order across the time shards)
            "offsets": offs.reshape(B, F),
        }

    fs = demod.params.nb_frame_samples
    T = n_time * frames_per_shard * fs
    if ingest == "u8":
        iq = jax.device_put(
            jnp.full((B, 2 * T), 127, jnp.uint8), time_sh)
    else:
        iq = jax.device_put(jnp.zeros((B, T, 2), jnp.float32), time_sh)
    carry = DemodCarry.init((B, n_time))
    carry = carry._replace(
        signal_l1_avg=jnp.full((B, n_time), 0.5, jnp.float32))
    carry = jax.device_put(carry, time_sh)
    deint_hist = jax.device_put(
        jnp.zeros((B, S, DEPTH, nb_sub_bits), jnp.int8), sub_sh)
    step.subchannel_cfgs = grid if per_stream else cfgs   # consumer metadata
    step.per_stream = per_stream
    step.msc_nb_data_bits = nb_data_list  # payload bits per (stream,) sub
    # stream-tail contract: pass the next block's first `tail_samples`
    # samples as `tail` so the final frame's timing margin reads real
    # data (a zero tail corrupts it whenever fine-time offset > 0)
    step.tail_samples = demod_fn.halo
    step.stop_after = stop_after
    return step, (carry, deint_hist, iq)


def make_coldstart_timesharded_demod(demod: OFDMDemodulator, mesh: Mesh,
                                     frames_per_shard: int):
    """Sequence-parallel demod that ACQUIRES from a cold carry.

    The plain time-sharded demod only works in a
    pre-locked steady state. Here every 'time' shard runs the block null-dip
    search on its local samples, the earliest detection is elected via a
    global min (psum-style collective over 'time'), the frame phase is
    broadcast, and every shard then demodulates the frames that start inside
    its block — one jitted program, no host round trips. This parallelizes
    the reference's sequential acquisition state machine
    (src/ofdm/ofdm_demodulator.cpp:291-347) across chips.

    Input iq: (B, n_time * frames_per_shard * frame_samples, 2) f32 pairs,
    frame phase arbitrary. Returns fn(iq) -> (carry, bits, valid) with
    bits (B, n_time, f_loc, nb_frame_bits) and valid flags (False for
    pre-detection frames / desyncs / no-signal shards).
    """
    p = demod.params
    fs = p.nb_frame_samples
    n_time = mesh.shape["time"]
    f_loc = frames_per_shard
    T_loc = f_loc * fs
    halo = demod.window_len
    rewind = 2 * demod.cfg.null_search_nb_samples
    BIG = jnp.asarray(2 ** 30, jnp.int32)

    def local(iq_local, tail_local):
        axis = "time"
        idx = jax.lax.axis_index(axis)
        base = idx * T_loc
        # halo: the first window_len samples of the right neighbor (frames
        # can start anywhere in the local block after acquisition); the
        # globally last shard uses the caller-supplied stream tail so a
        # late-starting frame decodes real data instead of zeros
        right = [(i, (i - 1) % n_time) for i in range(n_time)]
        halo_s = jax.lax.ppermute(iq_local[:, :halo], axis, right)
        halo_s = jnp.where(idx == n_time - 1, tail_local, halo_s)
        ext = jnp.concatenate([iq_local, halo_s], axis=1)

        l1_loc = jax.vmap(lambda b: demod._l1(b))(iq_local)
        l1_g = jax.lax.pmean(l1_loc, axis)
        found, end_idx = jax.vmap(
            lambda b, l: demod._acquire_impl(b, l))(iq_local, l1_g)
        cand = jnp.where(found, base + end_idx.astype(jnp.int32), BIG)
        global_end = jax.lax.pmin(cand, axis)          # (B_loc,)
        ok = global_end < BIG
        null_start = jnp.maximum(
            global_end - p.nb_null_period - rewind, 0)
        # first frame start inside this shard, same phase on every shard
        local0 = jnp.where(null_start >= base,
                           null_start - base,
                           (fs - (base - null_start) % fs) % fs)
        in_range = local0 < T_loc      # shard wholly before detection: none
        local0 = jnp.minimum(local0, T_loc - 1)
        carry = DemodCarry.init((iq_local.shape[0],))._replace(
            signal_l1_avg=l1_g)

        def step(state, _):
            c, pos, alive = state
            win = jax.vmap(
                lambda e, q: jax.lax.dynamic_slice(
                    e, (q, 0), (demod.window_len, 2)))(ext, pos)
            new_c, out = jax.vmap(demod._frame_step_impl)(c, win)
            started = (base + pos) >= null_start
            okf = out["sync_ok"] & alive & ok & started & in_range
            c2 = jax.tree.map(
                lambda n, o: jnp.where(started & alive, n, o), new_c, c)
            pos2 = jnp.where(okf, pos + out["offset"] + fs,
                             jnp.where(started, pos, pos + fs))
            pos2 = jnp.clip(pos2, 0, T_loc - 1)
            alive2 = jnp.where(started, okf, alive)
            return (c2, pos2, alive2), {"bits": out["bits"], "valid": okf}

        (carry, _, _), outs = jax.lax.scan(
            step, (carry, local0.astype(jnp.int32),
                   jnp.ones_like(ok)), None, length=f_loc)
        bits = jnp.moveaxis(outs["bits"], 0, 1)        # (B_loc, f_loc, nb)
        valid = jnp.moveaxis(outs["valid"], 0, 1)
        carry = jax.tree.map(lambda x: x[:, None], carry)
        return carry, bits[:, None], valid[:, None]

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P("ens", "time"), P("ens", None, None)),
        out_specs=(P("ens", "time"), P("ens", "time", None, None),
                   P("ens", "time", None)),
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    def run(iq, tail=None):
        if tail is None:
            tail = jnp.zeros((iq.shape[0], halo, 2), jnp.float32)
        return jitted(iq, tail)

    run.halo = halo
    return run
