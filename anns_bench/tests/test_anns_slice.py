"""The traced run's device slice: a slice that captured no device operation
while requests completed in it fails the run, and the idle readers read
nothing (never a flat 100%) from a slice with no busy time."""

import types

import pytest

from anns_bench.cell import load_reader
from anns_bench.run import check_slice

IDLE = ("device.idle_pct.triage", "device.idle_pct.enc")


def _req(t_done):
    return types.SimpleNamespace(t_done=t_done)


def test_empty_slice_with_requests_in_it_fails_the_run():
    with pytest.raises(RuntimeError, match="no device operation"):
        check_slice({"span": (10.0, 13.0), "device_ops": []},
                    [_req(9.0), _req(11.5)])


def test_slice_with_device_ops_or_no_requests_passes():
    check_slice({"span": (10.0, 13.0), "device_ops": [["k1", 0.1]]},
                [_req(11.5)])
    check_slice({"span": (10.0, 13.0), "device_ops": []}, [_req(14.0)])


@pytest.mark.parametrize("name", IDLE)
def test_idle_reader_reads_nothing_without_busy_time(name):
    read = load_reader(name)
    run = types.SimpleNamespace(device={"busy_s": 0.0, "window_s": 3.0})
    assert read(run) is None
    run.device = None
    assert read(run) is None
    run.device = {"busy_s": 0.6, "window_s": 3.0}
    assert read(run) == pytest.approx(80.0)


def test_request_tail_leaves_out_the_profiled_slice():
    read = load_reader("request.p95_ms.triage")

    def req(send, ms):
        return types.SimpleNamespace(t_send=send, t_done=send + ms / 1e3)

    reqs = [req(1.0 + i * 0.01, 4.0) for i in range(40)]
    slow = [req(10.5 + i * 0.01, 50.0) for i in range(20)]
    run = types.SimpleNamespace(reqs=reqs + slow,
                                device={"span": (10.0, 13.0)})
    assert read(run) == pytest.approx(4.0)
    run.device = None
    assert read(run) == pytest.approx(50.0)
    run.reqs = slow
    run.device = {"span": (10.0, 13.0)}
    assert read(run) is None
