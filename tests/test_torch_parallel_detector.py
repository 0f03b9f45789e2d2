"""The detector's data-parallel step (``train/perception.py:
shard_train_step`` over ``make_detector_train_step``) on two gloo CPU ranks,
held as tests/test_torch_parallel_train.py holds ProxyNet's: against the
one-process step and JAX's ``shard_train_step`` on a 2-device mesh, from
JAX's fresh state, on a seeded batch of 4 frames of 64 × 96 (the
positives and valid boxes summed over the ranks before they divide).
Losses within 1e-4 relative, BN statistics within 3.5e-6, parameters
within 2·lr with Adam's sign flips under 1% of the scalars.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel_train import (  # noqa: E402
    check_sharded_step, sharded_step_run)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_detector_step_matches_one_process_and_jax(tmp_path):
    check_sharded_step("detector", sharded_step_run("detector", tmp_path))
