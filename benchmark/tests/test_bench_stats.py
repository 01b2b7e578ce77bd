"""The end-to-end arithmetic: one rate over the whole window, and the 95th
percentile over every request."""

import numpy as np

from benchmark.harness import loops
from benchmark.harness.main import Run, p95
from benchmark.harness.spans import Recorder


def _done(i, issued, done, samples):
    req = loops.Request(i, 1000 + i, 0, 64)
    z = np.zeros((0,), np.int64)
    return loops.Done(req, issued, done, samples, z, np.zeros((0, 3), np.float32),
                      np.zeros((0, 4), np.uint8))


def test_rate_is_all_samples_over_the_whole_window():
    # three requests of unequal length: the rate is samples over the window,
    # not a mean of per-request rates
    done = [_done(0, 0.0, 1.0, 100), _done(1, 1.0, 1.5, 100), _done(2, 1.5, 4.0, 200)]
    run = Run(None, done, (0.0, 4.0), Recorder(), None, {}, [], 0)
    assert run.samples == 400
    assert run.samples / run.window_s == 100.0
    mean_of_rates = np.mean([d.samples / d.latency for d in done])
    assert mean_of_rates != 100.0


def test_p95_is_over_every_request():
    lat = list(range(1, 201))  # 200 requests: 10 lie above the 95th percentile
    assert p95(lat) == np.percentile(np.asarray(lat, np.float64), 95)
    assert sum(v > p95(lat) for v in lat) == 10
    # one slow request among many moves it only as its rank says
    assert p95([1.0] * 199 + [100.0]) == 1.0
    assert p95([1.0] * 189 + [100.0] * 11) == 100.0


def test_requests_from_the_seed():
    frames = [56, 952, 504, 1400, 280, 1176, 728, 1624]
    film = {"frames": frames, "samples": {"spp": 64, "ranges": 1}}
    big = 2**31 + 45
    assert loops.request(film, big, 0) == loops.Request(0, frames[big % 8], 0, 64)
    # every seed runs through the same frames in the same cycle, from
    # another place
    for seed in (big, big + 5, 7):
        got = [loops.request(film, seed, i).frame for i in range(8)]
        assert sorted(got) == sorted(frames)
        k = frames.index(got[0])
        assert got == frames[k:] + frames[:k]
    preview = {"frames": [0], "samples": {"spp": 4, "ranges": 256}}
    r = [loops.request(preview, big, i) for i in range(300)]
    assert {x.frame for x in r} == {0}
    assert r[0].sample_base == 4 * (big % 256)
    assert len({x.sample_base for x in r[:256]}) == 256  # no two alike until it wraps
    px = loops.check_pixels(big, r[0], 1920 * 1080, 8)
    assert (px == loops.check_pixels(big, r[0], 1920 * 1080, 8)).all()
    assert not (px == loops.check_pixels(big + 1, r[0], 1920 * 1080, 8)).all()


def test_trace_arithmetic():
    from benchmark.harness.trace import Trace, idle_gaps, top_device_ops

    dev = [("void megakernel<1>(x)", 1.0, 3.0), ("Memcpy DtoH", 2.5, 3.5),
           ("void megakernel<1>(x)", 5.0, 6.0), ("add", 8.0, 12.0)]
    spans = [("window", -1, 1, 0.0, 10.0), ("render_entry", 0, 1, 0.5, 4.0),
             ("write_bmp", 0, 1, 4.0, 4.8), ("render_entry", 1, 1, 4.8, 7.0),
             ("frame_setup", 1, 2, 0.0, 9.0)]
    t = Trace(10.0, dev, spans)
    assert t.busy_intervals() == [(1.0, 3.5), (5.0, 6.0), (8.0, 10.0)]
    assert t.busy_s() == 5.5
    assert t.busy_s(2.0, 5.5) == 2.0
    k = r"(^|[^A-Za-z0-9_])(megakernel|wavefront)(<|\(|$)"
    assert t.device_time(k) == 3.0
    assert t.device_time(k, 0.5, 4.0) == 2.0  # the first entry's kernel time
    assert t.device_time(k, 2.0, 5.5) == 1.5
    # idle gaps [0, 1), [3.5, 5), [6, 8), each named by the client's span
    # around its middle: 0.5 in entry 0, 4.25 in the BMP write, 7.0 at the
    # end of entry 1 (the worker's span, thread 2, is not the client's)
    assert dict(idle_gaps(t, 1)) == {"render_entry": 3.0, "write_bmp": 1.5}
    t2 = Trace(10.0, dev, spans[:1])
    assert dict(idle_gaps(t2, 1)) == {"between requests": 4.5}
    assert top_device_ops(t) == [["void megakernel<1>(x)", 3.0], ["add", 2.0],
                                 ["Memcpy DtoH", 1.0]]
