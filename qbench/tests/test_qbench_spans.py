"""The readers of the program's own spans (``quegel.*``): round_host_ms,
admit_ms and step_launches on a synthetic trace whose numbers are worked
out by hand, nothing on a trace without those spans, and a traced run on
the CPU of each cell, held to the span metrics it lists (``cells.spans``)."""
import pytest

from qbench import trace
from qbench.tests import cells
from qbench.tests.cells import BENCH, CELLS
from qbench.tests.cells import only_what_the_run_loads  # noqa: F401
from qbench.tests.test_qbench_metrics import EVENTS, context, reader, x
from qbench.tests.tiny import make_root

OLD_TRACE_READERS = ("ops_device_ms", "propagate_roofline", "device_idle")
NEW_READERS = ("round_host_ms", "admit_ms", "step_launches")

# times in us, a 1,000 us window.  Round 100-500: admit 110-140, a
# superstep 150-350 (a count span's launch at 170, the gate's at 195, the
# kernel span's set and launch at 220 and 230, an op's launch at 315, and a
# call that launches nothing at 330), the barrier 360-460.  Round 600-800:
# a superstep 610-700 launching at 650, the barrier 710-790.  A launch at
# 850 outside every superstep, and a round 990-1100 that the window cuts.
PHASED = [
    x("user_annotation", "qbench.window", 0, 1000),
    x("user_annotation", "quegel.round", 100, 400),
    x("user_annotation", "quegel.admit", 110, 30),
    x("user_annotation", "quegel.step", 150, 200),
    x("user_annotation", "qbench.count", 160, 20),
    x("cuda_runtime", "cudaLaunchKernel", 170, 1, corr=1),
    x("user_annotation", "quegel.gate", 190, 10),
    x("cuda_runtime", "cudaLaunchKernel", 195, 1, corr=2),
    x("user_annotation", "quegel.kernel", 210, 90),
    x("cuda_runtime", "cudaMemsetAsync", 220, 1, corr=3),
    x("cuda_runtime", "cudaLaunchKernel", 230, 1, corr=4),
    x("cpu_op", "aten::add", 310, 10),
    x("cuda_runtime", "cudaLaunchKernel", 315, 1, corr=5),
    x("cuda_runtime", "cudaGetDevice", 330, 1),
    x("user_annotation", "quegel.sync", 360, 100),
    x("cuda_runtime", "cudaMemcpyAsync", 365, 1, corr=6),
    x("user_annotation", "quegel.round", 600, 200),
    x("user_annotation", "quegel.step", 610, 90),
    x("cuda_runtime", "cudaLaunchKernel", 650, 1, corr=7),
    x("user_annotation", "quegel.sync", 710, 80),
    x("cuda_runtime", "cudaLaunchKernel", 850, 1, corr=8),
    x("user_annotation", "quegel.round", 990, 110),
    x("user_annotation", "quegel.admit", 992, 2),
    x("user_annotation", "quegel.sync", 995, 3),
    x("kernel", "k", 240, 50, tid=99, corr=4),
]


@pytest.fixture
def phased():
    return trace.summarize(PHASED)


def test_the_program_span_readers_on_a_phased_trace(phased):
    ctx = context(phased)
    # (400 - 100 + 200 - 80) us over the window's two whole rounds
    assert reader("round_host_ms")(ctx) == pytest.approx(210 * 1e-3)
    # 110-140 and 992-994, whole inside the window though their round is not
    assert reader("admit_ms")(ctx) == pytest.approx(16 * 1e-3)
    # 195, 220, 230 and 315 in the first superstep, 650 in the second
    assert reader("step_launches")(ctx) == pytest.approx(2.5)


def test_a_trace_without_the_programs_spans_gives_none_of_them():
    ctx = context(trace.summarize(EVENTS))
    assert all(reader(n)(ctx) is None for n in NEW_READERS)
    assert all(reader(n)(context()) is None for n in NEW_READERS)


def test_supersteps_that_launch_nothing_give_no_launch_count(phased):
    bare = trace.summarize(e for e in PHASED if e["cat"] != "cuda_runtime")
    assert reader("step_launches")(context(bare)) is None
    assert reader("round_host_ms")(context(bare)) == pytest.approx(210 * 1e-3)


def test_the_programs_spans_move_no_trace_reader():
    """The readers of the device trace read the same on a trace with the
    program's spans as on the same trace with them taken out."""
    spanned = EVENTS[:3] + [x("user_annotation", "quegel.round", 30, 870),
                            x("user_annotation", "quegel.step", 40, 220)] + EVENTS[3:]
    kw = dict(peaks={"hbm_bytes_per_s": 3.35e12}, bytes_counted=int(3.35e12 * 25e-6))
    for name in OLD_TRACE_READERS:
        got = reader(name)(context(trace.summarize(spanned), **kw))
        assert got == reader(name)(context(trace.summarize(EVENTS), **kw)), name


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_the_programs_spans(tmp_path, workload):
    cells.spans(make_root(tmp_path), BENCH, workload)
