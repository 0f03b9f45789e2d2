"""How far the port's one-process distillation step is from the JAX
package's on the dry run's batch (``entry.dryrun_batch(4)``: 256²
proxies), from the same state (tests/test_torch_distill.py's
``both_states`` / ``port_state_like``): the largest BN running-statistic
gap relative to its statistic's scale, the largest parameter gap and the
losses' relative gaps. tests/test_torch_distill.py and
tests/test_torch_parallel_distill.py hold the step at 64².

    JAX_PLATFORMS=cpu python tests/probe_distill_jax_gap.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import conftest  # noqa: E402,F401  (the JAX settings of the tests)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from soccerplayershapepose_tpu.smpl import assets as jassets  # noqa: E402
from soccerplayershapepose_tpu.train import distill as jdistill  # noqa: E402

from soccerplayershapepose_torch import convert  # noqa: E402
from soccerplayershapepose_torch.entry import dryrun_batch  # noqa: E402
from soccerplayershapepose_torch.smpl import synthesize_assets  # noqa: E402
from soccerplayershapepose_torch.train import distill  # noqa: E402

from test_torch_distill import both_states, port_state_like  # noqa: E402


def main(b: int = 4) -> dict:
    jreg, jstate, tx = both_states()
    state = port_state_like(jstate)
    batch = dryrun_batch(b)
    nb = {k: v.numpy() for k, v in batch.items()}
    nb["proxy"] = np.ascontiguousarray(nb["proxy"].transpose(0, 2, 3, 1))
    jstate, jm, _ = jax.jit(jdistill.make_train_step(jreg, tx))(
        jstate, jassets.synthesize_assets(),
        {k: jnp.asarray(v) for k, v in nb.items()})
    state, m, _ = distill.make_train_step()(state, synthesize_assets(),
                                            batch)
    got = convert.regressor_flat_from_state_dict(
        state.regressor.state_dict())
    want = convert.flatten_tree(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    stats, params = {}, 0.0
    for k, w in want.items():
        w = np.asarray(w)
        gap = float(np.abs(got[k] - w).max())
        if k.startswith("batch_stats/"):
            stats[k] = gap / max(float(np.abs(w).max()), 1e-12)
        else:
            params = max(params, gap)
    worst = sorted(stats.items(), key=lambda kv: -kv[1])[:3]
    out = {"b": b, "proxy_wh": int(batch["proxy"].shape[-1]),
           "bn_stats_rel_worst": worst, "params_max_abs": params,
           "loss_rel": {k: abs(float(m[k]) - float(v)) / abs(float(v))
                        for k, v in jm.items()}}
    print(out)
    return out


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
