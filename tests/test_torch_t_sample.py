"""The Student-t and chi-square samplers' arithmetic after their generator
calls (`ops.t_sample`): the restructured samplers against the composition
they ran before, the rule that decides where the kernel runs, and, on the
card, the kernel itself.

On the CPU: `distributions.student_t_sample` and `chi2_sample` (which now
make their generator calls around one step a group of uniforms) against a
frozen copy of the composition they ran before, bit for bit, and the
generator's next draw after them; the plain step on hand-made uniforms
holding 0, subnormals and 1; a CPU generator launching nothing; a
non-integer df and a df above 200 taking the gamma sampler.

On the card (marker ``cuda``; no JAX is imported:
``python -m pytest tests/test_torch_t_sample.py -m cuda -q --noconftest``):
the kernel's t and chi-square forms against the plain path bit for bit on
the same generator seeds, float32 and float64, df at the groups' edges,
odd and even, shapes whose sizes are no multiple of 4, the generator's
next draw, hand-made uniforms, a captured CUDA graph's replays, the
launch counts, the buffers a draw holds at once and the refusal of a
buffer that is not 16-byte aligned.
"""
import math
import re

import pytest
import torch

from viabel_tpu_torch import _device
from viabel_tpu_torch import distributions as td
from viabel_tpu_torch.ops import _launch, t_sample

DFS = (1, 3, 5, 20, 21, 40, 41, 199, 200)
DTYPES = (torch.float32, torch.float64)
SHAPES = ((1001, 10), (1003,), (3, 101, 10))  # numel 10010, 1003, 3030
SEEDS = (0, 11, 2 ** 31 + 7)


# --------------------------------------------------------------------------
# the composition the samplers ran before the kernel, frozen
# --------------------------------------------------------------------------

def _frozen_gamma_integer_shape(generator, k, shape, dtype):
    device = generator.device
    tiny = torch.finfo(dtype).tiny
    total = torch.zeros(shape, dtype=dtype, device=device)
    i = 0
    while i < k:
        group = min(10, k - i)
        prod = torch.ones(shape, dtype=dtype, device=device)
        for _ in range(group):
            u = torch.rand(shape, generator=generator, dtype=dtype,
                           device=device).clamp_min_(tiny)
            prod.mul_(u)
        total.sub_(torch.log(prod))
        i += group
    return total


def _frozen_chi2(generator, df_int, shape, dtype):
    chi2 = torch.zeros(shape, dtype=dtype, device=generator.device)
    if df_int // 2 > 0:
        chi2 = 2.0 * _frozen_gamma_integer_shape(generator, df_int // 2,
                                                 shape, dtype)
    if df_int % 2 == 1:
        z1 = torch.randn(shape, generator=generator, dtype=dtype,
                         device=generator.device)
        chi2 = chi2 + z1 * z1
    return chi2


def _frozen_t(generator, df, shape, dtype):
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return z * torch.sqrt(df / _frozen_chi2(generator, df, shape, dtype))


FROZEN = {'t': _frozen_t, 'chi2': _frozen_chi2}
SAMPLER = {'t': td.student_t_sample, 'chi2': td.chi2_sample}


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _draw_and_next(sampler, device, seed, df, shape, dtype):
    """A draw and the generator's next uniform after it."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = sampler(g, df, shape, dtype)
    return x, torch.rand(3, generator=g, dtype=torch.float64, device=device)


@pytest.mark.parametrize('form', ['t', 'chi2'])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('df', DFS)
def test_samplers_equal_the_frozen_composition(df, dtype, form):
    for seed in SEEDS:
        for shape in SHAPES[:2]:
            x, nxt = _draw_and_next(SAMPLER[form], 'cpu', seed, df, shape,
                                    dtype)
            y, nxt_frozen = _draw_and_next(FROZEN[form], 'cpu', seed, df,
                                           shape, dtype)
            assert _same_bits(x, y), (seed, shape)
            assert torch.equal(nxt, nxt_frozen)  # the same calls were made


def _hand_made(dtype, n=37, device='cpu'):
    """Two groups of uniforms (10 and 3) holding 0, -0, subnormals, tiny,
    1 and ordinary values, and z, z1 holding 0 and signs."""
    tiny = torch.finfo(dtype).tiny
    special = torch.tensor([0.0, -0.0, tiny / 4, tiny / 1024, tiny, 1.0,
                            0.5, 2.0 ** -24, 1.0 - 2.0 ** -24],
                           dtype=dtype)
    g = torch.Generator().manual_seed(5)
    uniforms = []
    for j in range(13):
        u = torch.rand(n, generator=g, dtype=dtype)
        u[j % n] = special[j % len(special)]
        u[(3 * j + 1) % n] = special[(j + 4) % len(special)]
        uniforms.append(u.to(device))
    z = torch.randn(n, generator=g, dtype=dtype)
    z[0], z[1] = 0.0, -0.0
    z1 = torch.randn(n, generator=g, dtype=dtype)
    z1[2] = 0.0
    return uniforms, z.to(device), z1.to(device)


def _frozen_steps(uniforms, z, z1, df):
    """The frozen composition's arithmetic on given draws."""
    tiny = torch.finfo(z.dtype).tiny
    total = torch.zeros_like(z)
    for group in (uniforms[:10], uniforms[10:]):
        prod = torch.ones_like(z)
        for u in group:
            prod.mul_(u.clone().clamp_min_(tiny))
        total.sub_(torch.log(prod))
    chi2 = 2.0 * total
    if z1 is not None:
        chi2 = chi2 + z1 * z1
    return chi2 if df is None else z * torch.sqrt(df / chi2)


def _run_steps(step, uniforms, z, z1, df):
    total = torch.empty_like(uniforms[0])
    total = step(uniforms[:10], total, True, False)
    return step(uniforms[10:], total, False, True, z=z, z1=z1, df=df)


@pytest.mark.parametrize('form', ['t', 'chi2'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_plain_step_on_hand_made_uniforms(dtype, form):
    uniforms, z, z1 = _hand_made(dtype)
    before = [u.clone() for u in uniforms]
    zz, df = (z, 27) if form == 't' else (None, None)
    got = _run_steps(t_sample.t_from_uniforms_plain, uniforms, zz, z1, df)
    want = _frozen_steps(uniforms, z, z1, df)
    assert _same_bits(got, want)
    assert all(torch.equal(u, b) for u, b in zip(uniforms, before))


def test_cpu_draws_launch_nothing():
    before = dict(_launch.launches)
    for form in ('t', 'chi2'):
        SAMPLER[form](torch.Generator().manual_seed(1), 40, (50, 10))
    assert _launch.launches == before


def test_the_kernel_rule():
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    assert t_sample.takes(cuda, torch.float32)
    assert t_sample.takes('cuda:1', torch.float64)
    assert not t_sample.takes(cpu, torch.float32)
    assert not t_sample.takes(cpu, torch.float64)
    assert not t_sample.takes(cuda, torch.float16)
    assert not t_sample.takes(cuda, torch.bfloat16)
    with pytest.raises(TypeError, match='CUDA float32 or float64'):
        t_sample.t_from_uniforms([torch.rand(4)], torch.empty(4), True, True)


@pytest.mark.parametrize('form', ['t', 'chi2'])
@pytest.mark.parametrize('df', [2.5, 4.5, 201, 1e6])
def test_non_integer_and_large_df_take_the_gamma_sampler(monkeypatch, df,
                                                         form):
    calls = []
    gamma = td._chi2_gamma

    def counted(*args, **kwargs):
        calls.append(args[1])
        return gamma(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError('the exact construction ran')

    monkeypatch.setattr(td, '_chi2_gamma', counted)
    monkeypatch.setattr(td, '_chi2_exact', refused)
    x = SAMPLER[form](torch.Generator().manual_seed(4), df, (64, 3))
    assert calls == [df]
    assert x.shape == (64, 3) and torch.isfinite(x).all()


@pytest.mark.parametrize('df', [1, 20, 21, 40, 200])
def test_exact_df_never_takes_the_gamma_sampler(monkeypatch, df):
    def refused(*args, **kwargs):
        raise AssertionError('the gamma sampler ran')

    monkeypatch.setattr(td, '_chi2_gamma', refused)
    for form in ('t', 'chi2'):
        SAMPLER[form](torch.Generator().manual_seed(2), df, (8,))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _groups(df):
    return max(1, math.ceil((df // 2) / t_sample.GROUP))


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['t', 'chi2'])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('df', DFS)
def test_kernel_equals_plain_on_the_card(cuda, monkeypatch, df, dtype,
                                         form):
    for seed in SEEDS[1:]:
        for shape in SHAPES:
            _launch.reset_launches()
            x, nxt = _draw_and_next(SAMPLER[form], cuda, seed, df, shape,
                                    dtype)
            torch.cuda.synchronize()
            assert _launch.launches['t_from_uniforms'] == _groups(df)
            with monkeypatch.context() as m:
                m.setattr(t_sample, 'takes', lambda device, dtype: False)
                y, nxt_plain = _draw_and_next(SAMPLER[form], cuda, seed, df,
                                              shape, dtype)
            assert _launch.launches['t_from_uniforms'] == _groups(df)
            assert _same_bits(x, y), (seed, shape)
            assert torch.equal(nxt, nxt_plain)
            frozen, _ = _draw_and_next(FROZEN[form], cuda, seed, df, shape,
                                       dtype)
            assert _same_bits(x, frozen), (seed, shape)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['t', 'chi2'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_kernel_on_hand_made_uniforms(cuda, dtype, form):
    """Zeros, subnormals and 1 through the clamp, and a tail of one
    element past the 16-byte loads (n = 37)."""
    uniforms, z, z1 = _hand_made(dtype, device=cuda)
    zz, df = (z, 27) if form == 't' else (None, None)
    want = _run_steps(t_sample.t_from_uniforms_plain, uniforms, zz, z1, df)
    got = _run_steps(t_sample.t_from_uniforms, uniforms, zz, z1, df)
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['uniforms[3]', 'total', 'z', 'z1'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_kernel_refuses_a_misaligned_buffer(cuda, dtype, which):
    """A buffer one element past a 16-byte boundary is refused before the
    launch, whichever it is, and nothing is launched."""
    uniforms, z, z1 = _hand_made(dtype, device=cuda)
    buffers = {'uniforms[3]': uniforms[3], 'total': torch.empty_like(z),
               'z': z, 'z1': z1}
    t = buffers[which]
    buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
    buf[1:] = t
    buffers[which] = buf[1:]
    uniforms[3] = buffers['uniforms[3]']
    _launch.reset_launches()
    with pytest.raises(ValueError, match=r'{}.*16-byte'.format(
            re.escape(which))):
        t_sample.t_from_uniforms(uniforms[:10], buffers['total'], True,
                                 True, z=buffers['z'], z1=buffers['z1'],
                                 df=27)
    assert _launch.launches['t_from_uniforms'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_kernel_replays_in_a_graph(cuda, dtype):
    """Two launches captured through `_device.capture` replay to the
    plain path's bits, every replay, and count their launches."""
    n = 2 ** 16 + 3
    g = torch.Generator(device=cuda).manual_seed(8)
    z = torch.randn(n, generator=g, dtype=dtype, device=cuda)
    uniforms = [torch.rand(n, generator=g, dtype=dtype, device=cuda)
                for _ in range(20)]
    total = torch.empty_like(z)
    want = t_sample.t_from_uniforms_plain(uniforms[:10], total.clone(),
                                          True, False)
    want = t_sample.t_from_uniforms_plain(uniforms[10:], want, False, True,
                                          z=z, df=40)

    def body():
        t_sample.t_from_uniforms(uniforms[:10], total, True, False)
        t_sample.t_from_uniforms(uniforms[10:], total, False, True, z=z,
                                 df=40)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    _launch.reset_launches()
    graph = _device.capture(body, stream)
    torch.cuda.current_stream().wait_stream(stream)
    assert graph.launches == {'t_from_uniforms': 2}
    assert _launch.launches['t_from_uniforms'] == 0
    for replays in (1, 2, 3):
        total.fill_(float('nan'))
        _device.replay(graph)
        torch.cuda.synchronize()
        assert _same_bits(total, want)
        assert _launch.launches['t_from_uniforms'] == 2 * replays
        assert _launch.replayed['t_from_uniforms'] == 2 * replays


@pytest.mark.cuda
def test_draw_holds_at_most_13_buffers(cuda):
    """A df-41 draw (two groups of 10 uniforms and z1) holds at most a
    group's uniforms, z, z1, the total and the output at once: the
    previous group's uniforms are freed before the next group's draws."""
    shape = (65536, 8)  # 2 MiB, a multiple of the allocator's rounding
    nbytes = 4 * shape[0] * shape[1]
    g = torch.Generator(device=cuda).manual_seed(3)
    td.student_t_sample(g, 41, shape)  # the allocator's blocks, made once
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    x = td.student_t_sample(g, 41, shape)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert x.shape == shape
    assert peak <= 13 * nbytes, peak / nbytes


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    u = torch.rand(8, device=cuda)
    total = torch.empty(8, device=cuda)
    with pytest.raises(ValueError, match='1 to 10 uniforms'):
        t_sample.t_from_uniforms([u] * 11, total, True, True)
    with pytest.raises(ValueError, match='1 to 10 uniforms'):
        t_sample.t_from_uniforms([], total, True, False)
    with pytest.raises(ValueError, match='uniforms'):
        t_sample.t_from_uniforms([u.double()], total, True, True)
    with pytest.raises(ValueError, match='z1 must be'):
        t_sample.t_from_uniforms([u], total, True, True, z1=u[:4])
    with pytest.raises(ValueError, match='df'):
        t_sample.t_from_uniforms([u], total, True, True, z=u)
