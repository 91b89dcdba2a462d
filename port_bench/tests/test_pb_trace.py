"""The arithmetic of the trace and of the end-to-end statistics."""

import pytest

from port_bench import trace


def test_union_counts_overlaps_once():
    busy = trace.union([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 9.0)])
    assert busy == [(0.0, 3.0), (5.0, 6.0), (8.0, 9.0)]
    assert trace.covered(busy, 0.0, 10.0) == pytest.approx(5.0)
    assert trace.covered(busy, 2.0, 5.5) == pytest.approx(1.5)
    assert trace.gaps(busy, 0.0, 10.0) == [(3.0, 5.0), (6.0, 8.0), (9.0, 10.0)]
    assert trace.idle_pct(busy, 0.0, 10.0) == pytest.approx(50.0)
    # The summed device times of the same operations would read 5.7 busy.
    assert sum(b - a for a, b in [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 9.0)]) \
        == pytest.approx(6.2)


def test_trace_reads_spans_ops_and_idle_by_host():
    device = [(1.0, 2.0, "k1"), (1.5, 2.5, "k2"), (4.0, 4.5, "k1"), (6.0, 7.0, "k3")]
    host = [(0.5, 3.0, "aten::add", "cpu_op"), (2.6, 3.9, "aten::nonzero", "cpu_op"),
            (2.7, 3.8, "cudaStreamSynchronize", "cuda_runtime")]
    spans = [(0.0, 3.0, "pyramid"), (3.0, 8.0, "select"), (0.0, 8.0, "loop")]
    tr = trace.Trace(device, host, spans)
    assert tr.span_list("select") == [(3.0, 8.0)]
    assert tr.device_in(0.0, 3.0) == pytest.approx(1.5)
    assert tr.device_in(3.0, 8.0) == pytest.approx(1.5)
    assert tr.top_ops(0.0, 8.0) == [["k1", pytest.approx(1.5)], ["k2", pytest.approx(1.0)],
                                    ["k3", pytest.approx(1.0)]]
    # Gaps (0, 1), (2.5, 4), (4.5, 6), (7, 8): only the second begins inside an op.
    assert dict((n, s) for n, s in tr.idle_by_host(0.0, 8.0)) == {
        "python": pytest.approx(3.5), "aten::add": pytest.approx(1.5)}
    assert tr.host_at(3.0) == "aten::nonzero/cudaStreamSynchronize"
    assert tr.host_at(0.7) == "aten::add"
    assert tr.host_at(5.0) == "python"


def test_p95_over_all_batches_and_rate_over_the_window():
    latencies = [0.1] * 90 + [0.5] * 10
    assert trace.percentile(latencies, 95) == 0.5
    assert trace.percentile(latencies, 90) == 0.1
    assert trace.percentile([0.3], 95) == 0.3
    assert trace.percentile(list(range(1, 201)), 95) == 190
    assert trace.rate(64 * 300, 30.5) == pytest.approx(629.5081967)


@pytest.mark.parametrize("name,short", [
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor"
     "<float> > >(at::TensorIteratorBase&)", "elementwise_kernel[MulFunctor]"),
    ("void (anonymous namespace)::fused_octave_kernel<false>(float const*, int)",
     "fused_octave_kernel"),
    ("void at::native::tensor_kernel_scan_innermost_dim<int, std::plus<int> >(int*)",
     "tensor_kernel_scan_innermost_dim"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH"),
])
def test_short_kernel_names(name, short):
    assert trace.short_name(name) == short


def test_a_trace_is_whole_when_it_holds_every_operation_asked():
    host = [(0.0, 0.1, "cudaLaunchKernel", "cuda_runtime"), (0.2, 0.3, "cuLaunchKernel", "cuda_driver"),
            (0.4, 0.5, "cudaMemcpyAsync", "cuda_runtime"),
            (0.6, 0.7, "cudaStreamSynchronize", "cuda_runtime"), (0.0, 1.0, "aten::add", "cpu_op")]
    whole = trace.Trace([(0.1, 0.2, "k"), (0.3, 0.4, "k"), (0.5, 0.6, "Memcpy DtoH")], host, [])
    assert whole.asked() == 3 and len(whole.device) == 3
    partial = trace.Trace([(0.1, 0.2, "k")], host, [])
    assert len(partial.device) < partial.asked()
