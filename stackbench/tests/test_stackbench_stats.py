"""Rate and tail are taken over every request of the window, a planted
stall included."""

import time

from stackbench.registry import HERE, Registry
from stackbench.stats import percentile, rate


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95
    assert percentile(vals, 100) == 100
    assert percentile([7.0], 95) == 7.0


def test_a_stall_moves_rate_and_tail():
    fast = [0.1] * 99
    stalled = fast + [5.0]
    assert rate(100, sum(stalled)) < 0.7 * rate(100, sum(fast + [0.1]))
    # 1 stall in 100: the p95 stays, the p99 and the maximum see it
    assert percentile(stalled, 95) == 0.1
    assert percentile(stalled, 100) == 5.0
    many = [0.1] * 90 + [5.0] * 10
    assert percentile(many, 95) == 5.0


def test_drive_counts_every_request_and_the_whole_window():
    gen = Registry({"workloads": []}).generator("closed_loop")
    calls = []

    def request(i):
        calls.append(i)
        time.sleep(0.25 if i == 2 else 0.01)
        if i == 4:
            raise RuntimeError("planted failure")
        return i != 5

    lat, ok, window = gen.drive(request, 0.4)
    assert calls == list(range(len(lat)))
    assert lat[2] >= 0.25 and window >= sum(lat) * 0.99
    assert ok[4] is False and ok[5] is False and ok.count(False) == 2
    assert window >= 0.4
