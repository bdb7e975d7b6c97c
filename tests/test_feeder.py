"""Double-buffered ingest feeder tests: ordering, backpressure, EOS,
error propagation, the shared-stream source's tail lookahead, and
integration with the fused serving fleet (byte-identical to direct
process_round feeding).

Reference contract being modelled: ThreadedRingBuffer's blocking
producer/consumer coupling (examples/app_helpers/app_io_buffers.h:189-245).
"""

import io
import threading
import time

import numpy as np
import pytest

from dab_radio_tpu.host.feeder import (
    DoubleBufferedFeeder, FeederStats, shared_stream_source)


def _array_source(rounds):
    it = iter(rounds)

    def src():
        return next(it, None)
    return src


def test_feeder_preserves_order_and_content():
    rng = np.random.default_rng(0)
    rounds = [(rng.integers(0, 256, (2, 64)).astype(np.uint8), None)
              for _ in range(20)]
    with DoubleBufferedFeeder(_array_source(rounds), depth=2,
                              device_put=lambda x: x) as f:
        got = [blk for blk, tail in f]
    assert len(got) == 20
    for g, (r, _) in zip(got, rounds):
        np.testing.assert_array_equal(g, r)
    assert f.stats.rounds == 20


def test_feeder_eos_returns_none_once():
    with DoubleBufferedFeeder(_array_source([]), depth=2,
                              device_put=lambda x: x) as f:
        assert f.get(timeout=5.0) is None


def test_feeder_backpressure_bounds_inflight_rounds():
    """With depth=2 the staging thread may run at most depth+1 rounds
    ahead of the consumer (depth queued + one blocked in put)."""
    calls = []

    def src():
        if len(calls) >= 50:
            return None
        calls.append(len(calls))
        return np.zeros((1, 8), np.uint8), None

    with DoubleBufferedFeeder(src, depth=2, device_put=lambda x: x) as f:
        time.sleep(0.3)                       # consumer stalled
        assert len(calls) <= 2 + 2            # depth + in-put + in-read
        consumed = 0
        while f.get(timeout=5.0) is not None:
            consumed += 1
        assert consumed == 50
    assert f.stats.producer_wait_s > 0.2      # it really blocked


def test_feeder_saturates_slow_consumer():
    """Saturation semantics: with a source faster than
    the consumer, the feeder must never starve the consumer — after the
    first round, every get() is served from the pre-filled queue, so the
    consumer's aggregate wait stays negligible next to its own compute
    time (device_busy -> 1 when the source isn't the bottleneck)."""
    N = 30

    def src(n=iter(range(N))):
        return (np.zeros((1, 8), np.uint8), None) \
            if next(n, None) is not None else None

    consume_s = 0.01
    with DoubleBufferedFeeder(src, depth=2, device_put=lambda x: x) as f:
        t0 = time.time()
        rounds = 0
        while f.get(timeout=5.0) is not None:
            time.sleep(consume_s)              # simulated device round
            rounds += 1
        total = time.time() - t0
    assert rounds == N
    # consumer waited on the feeder for (at most) a small fraction of its
    # own compute time: the staging thread stayed ahead throughout
    assert f.stats.consumer_wait_s < 0.2 * N * consume_s, \
        (f.stats.consumer_wait_s, total)
    # and the producer was the one blocking (backpressure worked)
    assert f.stats.producer_wait_s > 0


def test_feeder_propagates_source_error():
    def src():
        raise RuntimeError("device unplugged")

    with DoubleBufferedFeeder(src, depth=2, device_put=lambda x: x) as f:
        with pytest.raises(RuntimeError, match="device unplugged"):
            f.get(timeout=5.0)


def test_feeder_close_unblocks_producer():
    def src():
        return np.zeros((1, 8), np.uint8), None   # infinite source

    f = DoubleBufferedFeeder(src, depth=1, device_put=lambda x: x)
    time.sleep(0.2)
    f.close()                                  # must not hang
    assert not f._thread.is_alive()


def test_shared_stream_source_tail_is_next_round_head():
    data = bytes(range(256)) * 4               # 1024 bytes
    src = shared_stream_source(io.BytesIO(data), nb_streams=3,
                               round_bytes=300, tail_bytes=50)
    blk0, tail0 = src()
    assert blk0.shape == (3, 300) and tail0.shape == (3, 50)
    np.testing.assert_array_equal(
        blk0[0], np.frombuffer(data[:300], np.uint8))
    np.testing.assert_array_equal(
        tail0[0], np.frombuffer(data[300:350], np.uint8))
    np.testing.assert_array_equal(blk0[0], blk0[2])   # broadcast rows
    blk1, tail1 = src()
    np.testing.assert_array_equal(
        blk1[0], np.frombuffer(data[300:600], np.uint8))
    np.testing.assert_array_equal(
        tail1[0], np.frombuffer(data[600:650], np.uint8))
    blk2, tail2 = src()
    # 124 bytes remain: not a whole round, but enough for round 2's tail
    np.testing.assert_array_equal(
        tail2[0], np.frombuffer(data[900:950], np.uint8))
    assert src() is None                       # partial final round dropped


@pytest.mark.slow
def test_feeder_drives_fused_fleet_identically(tmp_path):
    """Feeder-fed rounds produce the identical AU stream to direct
    process_round feeding (CPU backend)."""
    import subprocess, sys, os
    from dab_radio_tpu.params import SubchannelConfig
    from dab_radio_tpu.models.fused_fleet import FusedFleet

    cache = tmp_path / "iq.u8"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, "-m", "dab_radio_tpu.apps.simulate_transmitter",
         "--payload", "ensemble", "--services", "1", "-n", "19",
         "-F", "u8", "--backend", "cpu"],
        stdout=open(cache, "wb"), check=True, env=env, timeout=600)
    iq = np.fromfile(cache, dtype=np.uint8)

    cfgs = [SubchannelConfig(0, 48, False, eep_type="A", eep_prot_level=2)]

    def au_collector(fleet):
        got = []
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, hdr: got.append((b, s, i, bytes(au))))
        return got

    def run(use_feeder):
        fleet = FusedFleet(2, cfgs, frames_per_step=4)
        got = au_collector(fleet)
        rb, tb = 2 * fleet.round_samples, fleet.tail_bytes
        if use_feeder:
            src = shared_stream_source(open(cache, "rb"), 2, rb, tb)
            with DoubleBufferedFeeder(src, depth=2) as f:
                for blk, tail in f:
                    fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
            fleet.flush()
        else:
            for r in range(iq.shape[0] // rb):
                blk = np.broadcast_to(iq[r * rb:(r + 1) * rb][None], (2, rb))
                t = iq[(r + 1) * rb:(r + 1) * rb + tb]
                tail = np.broadcast_to(t[None], (2, tb)) \
                    if t.shape[0] == tb else None
                fleet.process_round(blk, defer_fetch=True, tail_u8=tail)
            fleet.flush()
        return got

    direct = run(False)
    fed = run(True)
    assert len(direct) > 0
    assert fed == direct
