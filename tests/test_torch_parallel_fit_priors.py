"""The sharded silhouette fit of tests/test_torch_parallel_fit_sil.py with
the mint chain's priors (``betas_prior=0.01``, ``rot_ortho_prior=0.05``):
every row's prior gradient scales with the whole batch's ``|total|``,
built on each rank from one scalar all-reduce an iteration with the
log-variance terms counted once. The same bars: parameters within 1e-4,
translation 200×, IoU 1e-6, joint error 1e-5 relative, ``best_iter``
identical, against JAX's ``mesh=`` fit and the port's one-process fit.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel_fit import PRIORS  # noqa: E402
from test_torch_parallel_fit_sil import (  # noqa: E402
    SILHOUETTE, check_silhouette_case, silhouette_case)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_silhouette_fit_with_priors_matches_jax(tmp_path):
    check_silhouette_case(silhouette_case(
        tmp_path, dict(SILHOUETTE, **PRIORS), seed=1))
