"""Fleet orchestration: many ensembles decoded with cross-ensemble batching.

The north-star workload (ROADMAP.md) is many concurrent real-time Mode-I
ensembles per card. A naive fleet runs one DabReceiver per ensemble and pays
one FIC dispatch plus one MSC dispatch per channel per frame — O(ensembles x
subchannels) tiny device calls. This orchestrator flips that (the batched
analog of the reference's per-subchannel thread pool, basic_radio.cpp:51-62, scaled
across ensembles):

  * FIC: every receiver's CIF groups stack into ONE Viterbi batch per round
    (N ensembles x 4 groups lanes).
  * MSC: all active subchannels across ALL ensembles group by protection
    shape (dab.msc.group_key) and decode in one dispatch per shape.

Host byte-level work (FIG parse, superframe/PAD/MOT, database) stays
per-receiver and untouched, so fleet decode is bit-identical to running the
receivers standalone (tests/test_fleet.py).
"""

from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..params import get_dab_params
from ..dab.fic import _fic_decode_fn
from ..dab.msc import (MSCDecodeGroup, dispatch_frame_group,
                       finalize_frame_group, group_key)
from ..utils.profiler import profile_scope
from .receiver import DabReceiver


class ReceiverFleet:
    """N independent ensembles, one device-batched decode path.

    pipeline_depth > 0 defers the host fetch of each round's decoded bits by
    that many rounds, so device dispatches of round t overlap the transfer of
    round t-depth (hides the device round trip behind the next dispatch;
    the analog of the reference's
    ThreadedRingBuffer between OFDM and radio threads). Side effect: FIG
    ingest — and therefore channel discovery — lags `depth` frames, which
    only delays a new channel's first decoded frame."""

    def __init__(self, nb_receivers: int, transmission_mode: int = 1,
                 benchmark_all: bool = False, pipeline_depth: int = 0):
        self.dab = get_dab_params(transmission_mode)
        self.receivers: List[DabReceiver] = [
            DabReceiver(transmission_mode, benchmark_all=benchmark_all)
            for _ in range(nb_receivers)]
        self.spec, self._fic_decode = _fic_decode_fn()
        self.total_frames = 0
        self.pipeline_depth = pipeline_depth
        self._pending = deque()
        # persistent device-resident decode groups, rebuilt only when the
        # channel membership of a protection shape changes
        self._groups: Dict[tuple, Tuple[MSCDecodeGroup, list]] = {}

    # ---- pipelined rounds ----

    def _split(self, frame):
        """split_frame generic over host (np) and device (jnp) rows —
        device rows slice lazily, so demod output chains into FIC/MSC
        decode without fetching the 230k soft bits per frame to host."""
        bits = frame.reshape(-1)
        fic = bits[: self.dab.nb_fic_bits]
        cifs = bits[self.dab.nb_fic_bits:].reshape(
            self.dab.nb_cifs, self.dab.nb_cif_bits)
        return fic, cifs

    def _dispatch(self, frames):
        idxs = [i for i, _ in frames]
        assert len(set(idxs)) == len(idxs), "one frame per receiver per round"

        fics, all_cifs = [], {}
        for i, frame in frames:
            fic, cifs = self._split(frame)
            fics.append(fic.reshape(self.receivers[i].fic.nb_groups, -1))
            all_cifs[i] = cifs
        groups_per_rx = [f.shape[0] for f in fics]
        with profile_scope("fleet/fic_dispatch"):
            stacked = jnp.concatenate(fics, axis=0)
            fic_bits, _err = self._fic_decode(stacked)

        # MSC jobs use the channel set as of the last finalized round
        jobs: Dict[object, list] = {}
        for i, _ in frames:
            for ch in list(self.receivers[i].channels.values()):
                key = group_key(ch.msc.cfg)
                jobs.setdefault(key, []).append((ch, all_cifs[i]))
        handles = []
        with profile_scope("fleet/msc_dispatch"):
            for key, chans in jobs.items():
                members = tuple(id(ch) for ch, _ in chans)
                cached = self._groups.get(key)
                if cached is None or cached[1] != list(members):
                    if cached is not None:
                        cached[0].sync_back()
                    cached = (MSCDecodeGroup([ch.msc for ch, _ in chans]),
                              list(members))
                    self._groups[key] = cached
                h = cached[0].dispatch([c for _, c in chans])
                handles.append(([ch for ch, _ in chans], h))

        self._pending.append((list(frames), groups_per_rx, fic_bits, handles))

    def _finalize_one(self):
        frames, groups_per_rx, fic_bits, handles = self._pending.popleft()
        with profile_scope("fleet/fic_finalize"):
            bits = np.asarray(fic_bits, dtype=np.uint8)
        ofs = 0
        for (i, _), g in zip(frames, groups_per_rx):
            rx = self.receivers[i]
            fibs, _ = rx.fic.postprocess(bits[ofs:ofs + g])
            ofs += g
            rx.ingest_fibs(fibs)
        with profile_scope("fleet/msc_finalize"):
            for chans, h in handles:
                for ch, payloads in zip(chans, finalize_frame_group(h)):
                    for p in payloads:
                        if p is not None:
                            ch._handle_payload(p)
        for i, _ in frames:
            self.receivers[i].total_frames += 1
        self.total_frames += len(frames)

    def process_frames(self, frames: Sequence[Tuple[int, np.ndarray]]):
        """One round: frames is a sequence of (receiver_index, frame_soft_bits)
        — typically the per-stream output of MultiStreamDemodulator.step().
        At most one frame per receiver per round.

        Synchronous mode (depth 0) ingests each frame's FIC before
        collecting its MSC jobs, so a channel completed by this frame's FIGs
        decodes this same frame — identical to DabReceiver.process_frame."""
        if not frames:
            while len(self._pending) > self.pipeline_depth:
                self._finalize_one()
            return
        if self.pipeline_depth == 0:
            idxs = [i for i, _ in frames]
            assert len(set(idxs)) == len(idxs), \
                "one frame per receiver per round"
            fics, all_cifs = [], {}
            for i, frame in frames:
                fic, cifs = self._split(frame)
                fics.append(fic.reshape(self.receivers[i].fic.nb_groups, -1))
                all_cifs[i] = cifs
            with profile_scope("fleet/fic_decode"):
                stacked = jnp.concatenate(fics, axis=0)
                fic_bits, _err = self._fic_decode(stacked)
                bits = np.asarray(fic_bits, dtype=np.uint8)
            ofs = 0
            for (i, _), f in zip(frames, fics):
                rx = self.receivers[i]
                fibs, _ = rx.fic.postprocess(bits[ofs:ofs + f.shape[0]])
                ofs += f.shape[0]
                rx.ingest_fibs(fibs)
            jobs: Dict[object, list] = {}
            for i, _ in frames:
                for ch in list(self.receivers[i].channels.values()):
                    jobs.setdefault(group_key(ch.msc.cfg), []).append(
                        (ch, all_cifs[i]))
            with profile_scope("fleet/msc_decode"):
                for chans in jobs.values():
                    h = dispatch_frame_group(
                        [ch.msc for ch, _ in chans], [c for _, c in chans])
                    for ch, payloads in zip([c for c, _ in chans],
                                            finalize_frame_group(h)):
                        for p in payloads:
                            if p is not None:
                                ch._handle_payload(p)
            for i, _ in frames:
                self.receivers[i].total_frames += 1
            self.total_frames += len(frames)
            return

        self._dispatch(frames)
        while len(self._pending) > self.pipeline_depth:
            self._finalize_one()

    def flush(self):
        """Finalize every in-flight round (call when the streams end)."""
        while self._pending:
            self._finalize_one()
        for g, _ in self._groups.values():
            g.sync_back()

    # ---- checkpoint/resume ----

    def snapshot(self) -> bytes:
        """Serialize every receiver's decode state (in-flight rounds are
        finalized first). Observers/codecs re-attach after restore."""
        import pickle
        self.flush()
        return pickle.dumps({
            "mode": self.dab.mode,
            "receivers": self.receivers,
            "total_frames": self.total_frames,
            "pipeline_depth": self.pipeline_depth,
        })

    @classmethod
    def from_snapshot(cls, blob: bytes) -> "ReceiverFleet":
        import pickle
        d = pickle.loads(blob)
        fleet = cls(0, d["mode"], pipeline_depth=d["pipeline_depth"])
        fleet.receivers = d["receivers"]
        fleet.total_frames = d["total_frames"]
        return fleet

    def summary(self) -> dict:
        return {
            "receivers": len(self.receivers),
            "frames": self.total_frames,
            "ensembles_discovered": sum(
                1 for r in self.receivers if r.db.services),
            "channels": sum(len(r.channels) for r in self.receivers),
        }
