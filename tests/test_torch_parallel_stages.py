"""The port's single-view stage with ``mesh=`` on two gloo CPU ranks
against the JAX package's stage with ``mesh=`` on two virtual CPU devices
and against the port's one-process stage, on the same tree
(``test_torch_scene_tree.make_tree``: players 1-4, 2 views each, 64²
proxies; the committed ``weights/regressor_18ch_f16.npz``), joints-only,
3 iterations, batches of 4: the 6 views of players 2-4 make a full batch
and one of 2 views padded by repeating the last (masked out), on every
side alike.

Only rank 0 writes; it writes the files JAX's mesh stage writes, and the
one-process stage's, within the joints-only fits' bars
(tests/test_torch_stages.py: 1e-5, translations 200×, IoU 1e-6, joint
error 1e-5 relative), and every rank returns the same means.

A batch size that is no multiple of the data axis (3 on 2) is refused
with ``ValueError`` by both packages' stages, as their fits refuse it.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from soccerplayershapepose_tpu.drivers import stages as jst  # noqa: E402
from soccerplayershapepose_tpu.fit import FitConfig as JFitConfig  # noqa
from soccerplayershapepose_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jmake_mesh)
from soccerplayershapepose_tpu.pipeline import predict as jpred  # noqa: E402
from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402

from soccerplayershapepose_torch.drivers import stages as tst  # noqa: E402
from soccerplayershapepose_torch.fit import FitConfig  # noqa: E402
from soccerplayershapepose_torch.parallel import Mesh  # noqa: E402

from test_torch_scene_tree import make_tree  # noqa: E402
from test_torch_stages import (  # noqa: E402
    JOINTS_TOL, WEIGHTS, WH, assert_means_agree, assert_trees_agree)
from test_torch_synth_eval import _nest  # noqa: E402
from torch_parallel_harness import Ranks  # noqa: E402

BATCH = 4
FIT = dict(iters=3, proxy_wh=WH, faces_per_chunk=86, use_silhouette=False,
           silhouette_metrics=False)


def jax_stage(root, result_root, batch_size):
    """JAX's single-view stage on a 2-device mesh, on the committed
    weights."""
    with np.load(WEIGHTS) as z:
        variables = _nest({k: z[k] for k in z.files})
    _, _, jfn = jpred.build_predictor(proxy_wh=WH)
    return jst.single_view_optimization(
        jassets.synthesize_assets(), str(root / "images"),
        str(root / "proxies"), str(result_root), params=variables,
        regressor_fn=jfn, fit_cfg=JFitConfig(use_pallas=False, **FIT),
        batch_size=batch_size, verbose=False,
        mesh=jmake_mesh(jax.devices("cpu")[:2]))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_single_view_stage_writes_the_one_process_files(tmp_path):
    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.pipeline.predict import predict_smpl
    from soccerplayershapepose_torch.smpl import synthesize_assets

    make_tree(tmp_path / "tree", n_players=4, first_player_id=1)
    img, prx = str(tmp_path / "tree" / "images"), str(
        tmp_path / "tree" / "proxies")
    ranks = Ranks("stage", 2, tmp_path, image_root=img, proxy_root=prx,
                  result_root=str(tmp_path / "mesh"), weights=WEIGHTS,
                  proxy_wh=WH, batch_size=BATCH, fit_kw=FIT)
    model = convert.load_regressor_weights(WEIGHTS, "cpu")
    want = tst.single_view_optimization(
        synthesize_assets(), img, prx, str(tmp_path / "one"),
        regressor_fn=lambda a, s, j: predict_smpl(model, a, s, j,
                                                  proxy_wh=WH, device="cpu"),
        fit_cfg=FitConfig(**FIT), batch_size=BATCH, verbose=False,
        device="cpu")
    jwant = jax_stage(tmp_path / "tree", tmp_path / "jax", BATCH)
    got = ranks.wait()
    assert want["count"] == jwant["count"] == 6     # player '1' skipped
    for r in got:
        assert_means_agree(r, want)
        assert_means_agree(r, jwant)
    assert not os.path.exists(tmp_path / "mesh" / "rank1")
    files = assert_trees_agree(tmp_path / "one", tmp_path / "mesh" / "rank0",
                               JOINTS_TOL)
    assert len([f for f in files if f.endswith(".npz")]) == 6
    assert assert_trees_agree(tmp_path / "jax", tmp_path / "mesh" / "rank0",
                              JOINTS_TOL) == files


def test_batch_off_the_data_axis_is_refused_as_jax_refuses_it(tmp_path):
    """Batches of 3 on a data axis of 2: no rank runs a collective before
    the fit refuses the batch, so one process holds the mesh's place."""
    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.pipeline.predict import predict_smpl
    from soccerplayershapepose_torch.smpl import synthesize_assets

    make_tree(tmp_path / "tree", n_players=2, first_player_id=1)
    with pytest.raises(ValueError, match="multiple of the data axis"):
        jax_stage(tmp_path / "tree", tmp_path / "jax", 3)
    model = convert.load_regressor_weights(WEIGHTS, "cpu")
    with pytest.raises(ValueError, match="multiple of the data axis"):
        tst.single_view_optimization(
            synthesize_assets(), str(tmp_path / "tree" / "images"),
            str(tmp_path / "tree" / "proxies"), str(tmp_path / "t"),
            regressor_fn=lambda a, s, j: predict_smpl(
                model, a, s, j, proxy_wh=WH, device="cpu"),
            fit_cfg=FitConfig(**FIT), batch_size=3, verbose=False,
            device="cpu", mesh=Mesh(shape={"data": 2, "model": 1}))
