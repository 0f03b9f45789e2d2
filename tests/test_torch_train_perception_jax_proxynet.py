"""A ProxyNet segment of the port's training driver against the JAX
script's steps, from JAX's state file and on JAX's own batches (head width
8, 64² crops, B = 2, rate 1e-3): the protocol and the bars of
``test_torch_train_perception_jax.py``, whose helpers this file uses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import perception as jtrain  # noqa
from soccerplayershapepose_tpu.train import synth as jsynth  # noqa: E402

from test_torch_e2e_eval import fast_raster  # noqa: E402,F401
from test_torch_perception_train import (  # noqa: E402
    JitNet, jit_update, positive_flips)
from test_torch_train_perception import cpu_args  # noqa: E402
from test_torch_train_perception_jax import (  # noqa: E402,F401
    STEPS, _one_torch_thread, assert_step_agrees, port_drawn_init, run_both)


def test_proxynet_segment_matches_jax(fast_raster, tmp_path):
    args = cpu_args(["proxynet", "--steps", str(STEPS), "--segment",
                     "1", "--log-every", "1", "--batch", "2", "--wh",
                     "64", "--channels", "8"], tmp_path)
    ja = jassets.load_assets()

    def jax_step(model, tx):
        return jtrain.make_proxynet_train_step(JitNet(model), jit_update(tx))

    def jax_batch(key):
        return jsynth.synth_crop_batch(ja, key, b=args.batch, wh=args.wh,
                                       occluders=True, domain_rand=True)

    def port_batch(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    for rec, jl, got, want, ref, lr, batch in run_both(
            "proxynet", args, jax_step, jax_batch, port_batch):
        assert positive_flips({k: np.asarray(v) for k, v in batch.items()},
                              wh=args.wh) == 0
        assert set(jl) == {"kp", "mask", "part", "uv", "total"}
        assert_step_agrees(rec, jl, {k: k for k in jl}, got, want, ref, lr,
                           "proxynet")
