"""The ``synthetic_smoke`` preset (DynamicVolleyball on ResNet-18 with live
BatchNorm, f32, 64x96) of the port against the JAX package, on the CPU:
seeded weights with perturbed BatchNorm affines and statistics (as
tests/test_torch_resnet.py perturbs them) and DIN convs (as
tests/test_torch_train.py), canonical stem, JAX under
``default_matmul_precision("highest")``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from din_tpu.data.synthetic import make_synthetic_batch
from din_tpu.experiments.predict import Predictor as JaxPredictor
from din_tpu.experiments.presets import PRESETS as JAX_PRESETS
from din_tpu.models.registry import build_model as jax_build_model
from din_tpu.train.engine import TrainState, init_model, make_train_step
from din_tpu.train.optim import make_optimizer as jax_make_optimizer
from din_tpu_torch.data.loader import to_device
from din_tpu_torch.experiments.predict import Predictor
from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from din_tpu_torch.nn.ref_export import jax_params_to_state_dict
from din_tpu_torch.train.engine import train_step
from din_tpu_torch.train.optim import make_optimizer
from test_torch_resnet import perturb_bn
from test_torch_train import _perturb
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def test_synthetic_smoke_matches_jax():
    """``synthetic_smoke`` (DynamicVolleyball on ResNet-18, f32, dropout 0
    here): the posteriors of 2 synthetic clips within rtol 1e-4 / atol
    1e-5 of din_tpu's, and one training step's loss within rtol 1e-4 and
    running statistics within 1e-5."""
    jcfg = JAX_PRESETS["synthetic_smoke"]().replace(folded_stem=False,
                                                   train_dropout_prob=0.0)
    cfg = PRESETS["synthetic_smoke"]().replace(train_dropout_prob=0.0)
    assert (cfg.backbone, cfg.lite_dim, cfg.num_boxes) == ("res18", 32, 12)
    batch = make_synthetic_batch(jcfg, 2, rng=np.random.RandomState(3))
    jmodel = jax_build_model(jcfg)
    variables = jax.device_get(init_model(jcfg, jmodel, batch))
    rng = np.random.RandomState(4)
    params = _perturb(variables["params"], rng)
    bb, st = perturb_bn(params["trunk"]["frames_scan"]["backbone"],
                        variables["batch_stats"]["trunk"]["frames_scan"]
                        ["backbone"], rng)
    params["trunk"]["frames_scan"]["backbone"] = bb
    stats = {"trunk": {"frames_scan": {"backbone": st}}}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in
         jax_params_to_state_dict(params, cfg, stats).items()}, strict=True)
    with jax.default_matmul_precision("highest"):
        ref = JaxPredictor(jcfg, {"params": params, "batch_stats": stats})(
            batch["images"], batch["boxes"])["activities"]
    got = Predictor(cfg, model, device="cpu")(batch["images"],
                                              batch["boxes"])["activities"]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)

    tx = jax_make_optimizer(jcfg, params)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=jax.jit(tx.init)(params),
                       rng=jax.random.PRNGKey(0))
    step = make_train_step(jmodel, jcfg, tx, True, True, donate=False)
    with jax.default_matmul_precision("highest"):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    out = train_step(model, make_optimizer(cfg, model),
                     to_device(batch, torch.device("cpu")), cfg)
    np.testing.assert_allclose(float(out["loss"]), float(m["loss"]),
                               rtol=1e-4)
    want = jax_params_to_state_dict(jax.device_get(state.params), cfg,
                                    jax.device_get(state.batch_stats))
    own = model.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(own[k].numpy(), want[k], rtol=0,
                                       atol=1e-5, err_msg=k)
