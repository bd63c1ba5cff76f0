"""``spans.py`` on hand-built traces (µs on the trace's clock): the
program's spans, the idle gaps put down to the innermost span of the
stepping thread, the five readings by hand, and ``trace.reduce``'s
numbers left as they were by the program's spans."""

from dataclasses import dataclass, field

import pytest
import torch

from port_bench import spans, trace
from port_bench.tests.tiny import kernel_ln_stream, tiny_root

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SEED = 2**31 + 977


@pytest.fixture
def fp32_cpu(monkeypatch):
    kernel_ln_stream(monkeypatch)


@dataclass
class Range:
    start: float
    end: float

    def elapsed_us(self) -> float:
        return self.end - self.start


@dataclass
class Event:
    name: str
    start: float
    end: float
    device_type: object = CPU
    thread: int = 1
    device_time_total: float = 0.0
    is_user_annotation: bool = False
    time_range: Range = field(init=False)

    def __post_init__(self):
        self.time_range = Range(self.start, self.end)


# the stepping thread 1: the benchmark's annotation around a step, the
# program's spans inside it; the feed thread 2; five kernels
STEP = [
    Event("port_bench.step", 0, 100, is_user_annotation=True),
    Event("plbert.step", 0, 100),
    Event("plbert.step.forward", 10, 40, device_time_total=30),
    Event("lm_head.capacity_read", 20, 30),
    Event("cudaStreamSynchronize", 21, 27),
    Event("plbert.step.optimizer", 60, 90, device_time_total=20),
]
FEED = [Event("plbert.feed.batch", 0, 50, thread=2), Event("plbert.feed.h2d", 40, 45, thread=2)]
KERNELS = [Event(f"k{i}", s, e, CUDA) for i, (s, e) in
           enumerate([(0, 10), (15, 25), (32, 50), (55, 70), (75, 100)])]
# what a record_function range leaves among the device's events
COPIES = [Event("port_bench.step", 0, 100, CUDA, is_user_annotation=True)]


def test_reduce_reads_the_spans_and_leaves_out_annotation_copies():
    red = spans.reduce(STEP + FEED + KERNELS + COPIES)
    assert red["kernels"] == [(s / 1e6, e / 1e6) for s, e in
                              [(0, 10), (15, 25), (32, 50), (55, 70), (75, 100)]]
    assert red["gaps"] == pytest.approx([(10e-6, 15e-6), (25e-6, 32e-6), (50e-6, 55e-6),
                                         (70e-6, 75e-6)])
    assert set(red["spans"]) == {"plbert.step", "plbert.step.forward", "plbert.step.optimizer",
                                 "lm_head.capacity_read", "plbert.feed.batch",
                                 "plbert.feed.h2d"}
    feed = red["spans"]["plbert.feed.batch"]
    assert feed["calls"] == 1 and feed["host_s"] == pytest.approx(50e-6)
    assert feed["intervals"] == [(0.0, 50e-6, 2)]
    assert red["spans"]["plbert.step.optimizer"]["device_s"] == pytest.approx(20e-6)


def test_a_gap_goes_to_the_innermost_span_of_the_stepping_thread():
    idle = spans.reduce(STEP + FEED + KERNELS + COPIES)["idle"]
    # (10, 15) in the forward, (25, 32) in the capacity read (its sync
    # ends at 27, before the gap's middle), (50, 55) in the step alone,
    # (70, 75) in the optimizer; the feed thread's spans are no labels
    assert idle == pytest.approx({"plbert.step.forward": 5e-6, "lm_head.capacity_read": 7e-6,
                                  "plbert.step": 5e-6, "plbert.step.optimizer": 5e-6})
    # a call that waits on the device, inside the span that made it
    synced = [Event("cudaStreamSynchronize", 21, 30) if e.name == "cudaStreamSynchronize"
              else e for e in STEP]
    idle = spans.reduce(synced + FEED + KERNELS + COPIES)["idle"]
    assert idle["lm_head.capacity_read > cudaStreamSynchronize"] == pytest.approx(7e-6)


def test_ranges_that_start_together_go_to_the_inner_one():
    events = [Event("plbert.step", 0, 100), Event("plbert.step.mask", 0, 30),
              Event("k0", 0, 5, CUDA), Event("k1", 15, 100, CUDA)]
    assert spans.reduce(events)["idle"] == pytest.approx({"plbert.step.mask": 10e-6})


def test_the_five_readings_by_hand():
    red = spans.reduce(STEP + FEED + KERNELS + COPIES)
    got = spans.readings(red, steps=2)
    # a capacity read returning at 30: last kernel end before it 25,
    # first start after it 32; the feed batch [0, 50] overlaps the gaps
    # (10, 15) and (25, 32)
    assert got == pytest.approx({"optimizer_ms": 20e-3 / 2, "feed_host_ms": 50e-3 / 2,
                                 "feed_overlap_idle_ms": 12e-3 / 2,
                                 "capacity_read_idle_ms": 7e-3 / 2})
    assert "device_mask_ms" not in got
    masked = spans.reduce(STEP + [Event("plbert.step.mask", 2, 8, device_time_total=4)]
                          + KERNELS)
    assert spans.readings(masked, steps=1)["device_mask_ms"] == pytest.approx(4e-3)


def test_the_feed_is_clipped_to_the_window():
    """The window is the stepping thread's and the kernels': a feed batch
    the profiler caught open at either end counts inside it alone."""
    early = spans.reduce(STEP + KERNELS + [Event("plbert.feed.batch", -40, 20, thread=2)])
    assert early["window"] == (0.0, 100e-6)
    assert spans.readings(early, 1)["feed_host_ms"] == pytest.approx(20e-3)
    late = spans.reduce(STEP + KERNELS + [Event("plbert.feed.batch", 90, 130, thread=2)])
    assert spans.readings(late, 1)["feed_host_ms"] == pytest.approx(10e-3)


def test_the_programs_spans_leave_the_accepted_reduction_as_it_was():
    """The program's spans leave no copy among the device's events, so
    the accepted harness's numbers of a trace do not change with them."""
    base = [STEP[0], STEP[3], STEP[4]] + KERNELS + COPIES
    with_spans = base + [STEP[1], STEP[2], STEP[5]] + FEED
    assert trace.reduce(with_spans) == trace.reduce(base)


def test_a_tiny_cell_traced_on_the_cpu(tmp_path, fp32_cpu):
    """Every span on a packed multi-task cell's step, the feed's from
    another thread than the step's, and no step time without a card."""
    out = spans.measure(tiny_root(tmp_path, "mt_train_packed"), "tiny", SEED, 2, device="cpu")
    assert out["step_ms_traced_median"] is None and out["device_idle_pct"] is None
    got = out["spans"]
    for name, calls in (("plbert.step", 1), ("plbert.step.mask", 2), ("plbert.step.forward", 2),
                        ("plbert.step.backward", 2), ("plbert.step.optimizer", 1),
                        ("lm_head.capacity_read", 2)):
        assert got[name]["calls_a_step"] == calls and got[name]["threads"] == 1, name
    # a wait a step, and one more where an epoch ends inside the window
    assert got["plbert.feed.wait"]["calls_a_step"] >= 1
    assert got["plbert.feed.batch"]["calls_a_step"] > 0
    assert "feed_host_ms" in out["readings"] and "optimizer_ms" in out["readings"]


def test_a_tiny_cell_with_its_control_windows(tmp_path, fp32_cpu, monkeypatch):
    """``--control``: the stepping thread traced alone records none of the
    feed thread's spans; on batches made before the window the step
    never waits for one, and the feed thread has stopped."""
    monkeypatch.setattr(spans, "FEED_SETTLE_S", 0.2)
    out = spans.measure(tiny_root(tmp_path, "mt_train_packed"), "tiny", SEED, 2, device="cpu",
                        control=True)
    alone, ready = out["stepping_thread"]["spans"], out["batches_ready"]["spans"]
    assert alone["plbert.step"]["calls_a_step"] == 1 and "plbert.feed.batch" not in alone
    assert ready["plbert.step"]["calls_a_step"] == 1
    assert "plbert.feed.wait" not in ready and "plbert.feed.batch" not in ready
    assert "optimizer_ms" in out["batches_ready"]["readings"]
