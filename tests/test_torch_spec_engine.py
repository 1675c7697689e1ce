"""The port's speculative engine against the JAX package's on the device
sampling path (the default), on the CPU: token streams and per-round
accepted counts identical (tolerance 0) over spec_len 2 and 4 and draft
rank 0.5 and 0.9. The host sampling path and everything else are in
``test_torch_spec.py``, whose fixture and helpers this file shares (the
JAX engine compiles every new shape, so the two files split the work to
run in under a minute each)."""
import pytest

from test_torch_spec import (check_streams_identical, make_engines,
                             states)  # noqa: F401


@pytest.fixture(scope="module")
def device_engines(states):  # noqa: F811
    return make_engines(states, True)


@pytest.mark.parametrize("draft_rank", [0.5, 0.9])
@pytest.mark.parametrize("spec_len", [2, 4])
def test_spec_engine_streams_identical_device_sampling(
        states, device_engines, spec_len, draft_rank):  # noqa: F811
    check_streams_identical(states, *device_engines, spec_len, draft_rank)
