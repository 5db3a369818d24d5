"""One training step of SACRF+BiUTE against din_tpu's, on the CPU, with
the models, weights, helpers and tolerances of
tests/test_torch_baselines_train.py: the loss adds the halting loss times
``halting_penalty`` and the action loss of SACRF's posteriors.  (In its
own file: compiling din_tpu's SACRF gradient takes most of a file's
time budget.)
"""

from test_torch_baselines_train import check_train_step
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def test_one_train_step_matches_jax():
    check_train_step("sacrf")
