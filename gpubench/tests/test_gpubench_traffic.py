"""The traffic generator: the same seed gives the same scans, a scan
sweeps the orbit forth and back, and the live schedule queues late frames
and never drops one."""

import time

import numpy as np
import pytest

from gpubench import traffic
from gpubench.reference import scene


@pytest.mark.parametrize("mix", ["scan", "live"])
def test_deterministic_per_seed(mix):
    m = traffic.load(mix)
    a = traffic.Scans(m, 2 ** 31 + 17, 32, 48)
    b = traffic.Scans(m, 2 ** 31 + 17, 32, 48)
    c = traffic.Scans(m, 5, 32, 48)
    for k in range(3):
        ta, da = a.scan(k)
        tb, db = b.scan(k)
        tc, dc = c.scan(k)
        np.testing.assert_array_equal(ta, tb)
        assert da.phase == db.phase
        assert len(da) == len(ta) == m["scan_frames"]
        for i in (0, 7, m["scan_frames"] - 1):
            np.testing.assert_array_equal(da[i][1], db[i][1])
    assert not np.array_equal(a.pool, c.pool)


def test_scan_sweeps_the_orbit_forth_and_back():
    np.testing.assert_array_equal(scene.scan_index(12, 4),
                                  [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1])
    m = traffic.load("scan")
    o = m["orbit_frames"]
    traj, _ = traffic.Scans(m, 3, 16, 16).scan(0)
    orbit = traj[:o]
    # the second leg runs the first backwards, the third repeats it
    np.testing.assert_array_equal(traj[o - 1:2 * o - 1], orbit[::-1])
    np.testing.assert_array_equal(traj[2 * o - 2:3 * o - 2], orbit)
    # every step of the scan is one step of the orbit
    steps = np.linalg.norm(np.diff(traj[:, :3], axis=0), axis=1)
    assert steps.max() <= np.linalg.norm(np.diff(orbit[:, :3], axis=0),
                                         axis=1).max() + 1e-6


def test_frame_ids_stamped():
    m = dict(traffic.load("scan"), scan_frames=300)
    _, ds = traffic.Scans(m, 1, 16, 16).scan(0)
    for i in (0, 255, 299):
        img = ds[i][1]
        assert int(img[0, 0, 0]) + 256 * int(img[0, 0, 1]) == i


class _Counter:
    def __init__(self):
        self.index, self.taken_at = 0, []

    def next_index(self):
        self.index += 1
        return self.index - 1

    def taken(self, frame, due):
        self.taken_at.append((frame, due, time.perf_counter()))


def test_live_schedule_queues_and_never_drops():
    m = dict(traffic.load("live"), arrival={"rate_hz": 100.0},
             scan_frames=40)
    clock = traffic.Clock(m, 0.2)
    counter = _Counter()
    _, ds = traffic.Scans(m, 3, 16, 16).scan(0, clock=clock,
                                             counter=counter)
    clock.open()
    got = []
    with pytest.raises(traffic.WindowClosed):
        for i in range(len(ds)):
            ds[i]
            got.append(i)
            time.sleep(0.02)          # a consumer slower than the camera
    # every frame due before the close was handed out, in order, late
    assert got == list(range(20))
    dues = [d for _, d, _ in counter.taken_at]
    assert np.allclose(np.diff(dues), 0.01)
    lates = [t - d for _, d, t in counter.taken_at]
    assert lates[-1] > 0.1 and all(x >= -1e-3 for x in lates)


def test_closed_loop_stops_at_close():
    m = dict(traffic.load("scan"), scan_frames=1000)
    clock = traffic.Clock(m, 0.05)
    _, ds = traffic.Scans(m, 3, 16, 16).scan(0, clock=clock,
                                             counter=_Counter())
    clock.open()
    n = 0
    with pytest.raises(traffic.WindowClosed):
        for i in range(len(ds)):
            ds[i]
            n += 1
            time.sleep(0.01)
    assert 3 <= n <= 6
