"""Helpers shared by the tests of the port's example layer
(tests/test_torch_examples*.py)."""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch


def close_dicts(got, want, rtol, what):
    """`got` has `want`'s keys and each value within `rtol` of it."""
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], dtype=float),
                                   np.asarray(v, dtype=float), rtol=rtol,
                                   atol=1e-300, err_msg='{} {}'.format(
                                       what, k))


def quiet(fn, *args, **kw):
    """fn's result and what it printed."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs: the examples' eager steps
    are many small ops, and with a thread a core in each of the parallel
    test workers they crawl (10 s alone, 250 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
