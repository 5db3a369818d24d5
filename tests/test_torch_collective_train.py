"""One training step of the port's DynamicCollective against din_tpu's, on
the CPU, with the helpers, geometry and tolerances of
tests/test_torch_collective.py: the preset ``collective_stage2_dynamic``
(ResNet-18 with live BatchNorm, NFB 1024, 13 actors) at 64x96, T=3, three
clips with 13, 1 and mixed actor counts, dropout 0, with the backbone
frozen: BatchNorm still trains (``train and not set_bn_eval``), so its
running statistics move while no backbone parameter does.  (The Basenet's
step in tests/test_torch_collective_stage1.py trains the backbone.)
din_tpu's step runs eagerly: its jitted gradient is wrong here (the
docstring of tests/test_torch_collective.py gives the finite-difference
check), and the eager one compiles each primitive on its first call,
which is most of this file's time.
"""

import numpy as np
import pytest

from test_torch_collective import _setup, check_train_step
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dynamic():
    return _setup("collective_stage2_dynamic", 0, train_backbone=False)


def test_one_train_step_with_live_bn_and_frozen_backbone_matches_jax(
        dynamic):
    before = {k: v.clone() for k, v in dynamic["model"].state_dict().items()}
    model = check_train_step(dynamic, "dynamic", jit=False)
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("backbone."):
            moved = not np.array_equal(after[k].numpy(), v.numpy())
            assert moved == k.endswith(("running_mean", "running_var",
                                        "num_batches_tracked")), k
