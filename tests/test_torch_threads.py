"""One PyTorch thread for the port's CPU tests.

Tier-1 runs six pytest workers on the host's cores at once, and each
worker's PyTorch would start a thread per core for every CPU op. The
port's tests work on small tensors, whose ops gain nothing from threads
(one test file, alone on the host, runs as fast with one thread), while
six workers' threads spinning on the same cores slow every file down
severalfold. Each port test module imports the `one_torch_thread`
fixture below: it runs the module's tests, and its module-scoped
fixtures, on one PyTorch thread and restores the count afterwards, so
that the other test files keep their own.

    from test_torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_the_fixture_runs_the_module_on_one_thread():
    assert torch.get_num_threads() == 1


def test_one_thread_computes_what_many_threads_compute():
    """A reduction and a conv on one thread equal the same on the
    default count to float32 rounding (the order of a parallel sum is
    the only difference)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 20, 24, 28), generator=g)
    w = torch.randn((8, 3, 3, 3, 3), generator=g)
    one = (x.sum(), torch.nn.functional.conv3d(x, w, padding=1))
    torch.set_num_threads(max(2, torch.get_num_threads()))
    try:
        many = (x.sum(), torch.nn.functional.conv3d(x, w, padding=1))
    finally:
        torch.set_num_threads(1)
    for a, b in zip(one, many):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
