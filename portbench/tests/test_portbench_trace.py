"""The trace reader on a synthetic trace: the union of overlapping
device intervals, the idle share, kernel times by name, the spans, the
top operations and the idle time by host activity."""
import pytest

from portbench.trace import Record, Trace, short_name


def _trace():
    us = 1000
    recs = [
        Record('slice', 'user_annotation', 0, 100 * us),
        Record('draw', 'user_annotation', 10 * us, 40 * us),
        Record('psis', 'user_annotation', 50 * us, 90 * us),
        # device: two overlapping kernels, a copy, a kernel partly
        # outside the slice, a GPU annotation (not an operation)
        Record('void score_partials_kernel<float, 10>(Draws, float*)',
               'kernel', 12 * us, 20 * us),
        Record('void score_partials_kernel<float, 10>(Draws, float*)',
               'kernel', 18 * us, 30 * us),
        Record('Memcpy DtoH (Device -> Pageable)', 'gpu_memcpy',
               60 * us, 64 * us),
        Record('void adagrad_step_kernel<float>(float*)', 'kernel',
               95 * us, 110 * us),
        Record('draw', 'gpu_user_annotation', 10 * us, 40 * us),
        # host
        Record('aten::topk', 'cpu_op', 50 * us, 58 * us),
        Record('cudaStreamSynchronize', 'cuda_runtime', 64 * us, 65 * us),
    ]
    return Trace(recs)


def test_union_and_idle_share():
    t = _trace()
    assert t.busy_intervals() == [[12000, 30000], [60000, 64000],
                                  [95000, 100000]]
    assert t.window_s == pytest.approx(1e-4)
    assert t.busy_s == pytest.approx(27e-6)
    assert t.idle_share() == pytest.approx(0.73)


def test_kernels_spans_and_top():
    t = _trace()
    assert len(t.kernels()) == 3
    assert t.mean_kernel_s('score_partials_kernel') == pytest.approx(1e-5)
    assert t.mean_kernel_s('no_such_kernel') is None
    s, n = t.device_s_in_spans('draw')
    assert (s, n) == (pytest.approx(20e-6), 1)
    assert t.device_s_in_spans('bounds') == (None, 0)
    assert t.span_walls('psis') == [pytest.approx(4e-5)]
    top = t.top_ops()
    assert top[0] == ['score_partials_kernel', pytest.approx(20e-6)]
    assert ['adagrad_step_kernel', pytest.approx(5e-6)] in top
    assert short_name('Memcpy DtoH (Device -> Pageable)') == 'Memcpy DtoH'
    assert short_name('void at::native::(anonymous namespace)::cat_kernel'
                      '<float, 4>(float*, int)') == \
        'at::native::{anonymous}::cat_kernel'
    assert short_name('std::enable_if<!(false), void>::type at::native::'
                      'internal::gpu_kernel<8, f>(int, f)') == \
        'at::native::internal::gpu_kernel'
    assert short_name('cutlass::Kernel2<cutlass_80_gemm>(Params)') == \
        'cutlass::Kernel2'


def test_idle_by_host():
    # gaps (us): [0, 12) and [30, 60), midpoints 6 and 45, outside any
    # span and any host operation; [64, 95), midpoint 79.5, inside psis
    # after the runtime call ended
    idle = dict((k, v) for k, v in _trace().idle_by_host())
    assert idle == {'python': pytest.approx((12 + 30) * 1e-6),
                    'psis/python': pytest.approx(31e-6)}


def test_one_slice_span_required():
    with pytest.raises(ValueError):
        Trace([Record('x', 'kernel', 0, 1)])
