"""What the card test files (tests/test_torch_cuda.py and
tests/test_torch_cuda_paths.py) share: the `dev` fixture, which skips a
test without a CUDA device, and the bars that hold a kernel's output
against its plain version's. No JAX import."""

import numpy as np
import pytest
import torch

from torch_wide_cases import FIELDS


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_states_equal(got, want):
    """Every field of two bucket states, the counters too, bit for bit."""
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def assert_states_close(a, b, bf16):
    """Kernel F's bars (the JAX package's, tests/test_fused.py): ids equal,
    pos within 1e-6, vel and C within 1e-5 (bf16 storage: rtol 0.01 and
    atol 1e-4), counters equal."""
    np.testing.assert_array_equal(a.ids.cpu().numpy(), b.ids.cpu().numpy())
    np.testing.assert_allclose(a.pos.cpu().numpy(), b.pos.cpu().numpy(), atol=1e-6)
    for x, y in ((a.vel, b.vel), (a.C, b.C)):
        x, y = x.float().cpu().numpy(), y.float().cpu().numpy()
        if bf16:
            np.testing.assert_allclose(x, y, rtol=0.01, atol=1e-4)
        else:
            np.testing.assert_allclose(x, y, atol=1e-5)
    for name in FIELDS[5:]:
        assert int(getattr(a, name)) == int(getattr(b, name)), name


def assert_splats_equal(got, want):
    """Kernel X's bar: rows 2 (depth) and 4 (count) equal, rows 0, 1 and 3
    within rtol 1e-6 and atol 1e-5 (tests/test_render.py:370). Built
    without fused multiply-adds, the kernel rounds as the plain version
    does, so the rows are expected equal."""
    assert torch.equal(got[2], want[2]) and torch.equal(got[4], want[4])
    for r in (0, 1, 3):
        torch.testing.assert_close(got[r], want[r], rtol=1e-6, atol=1e-5)
