"""``collective_stage1`` (``BasenetCollective`` on Inception-v3) against
the JAX package, on the CPU, with an RoI map that matches neither
Inception-v3 scale: the checks of tests/test_torch_inception_model.py with
the RoI map 7x11 at 96x128 frames (Mixed_5d 9x13, Mixed_6e 4x6), so both
scales go through the resize rows composed into RoIAlign's and
``roi_align`` (kernel K1 on the card) runs on neither.  The tolerances are
that file's.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

from test_torch_inception_model import (check_stage1_predictor,
                                        check_stage1_train_step, stage1_case)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def neither():
    with ThreadPoolExecutor(3) as pool:
        yield stage1_case((7, 11), pool)


def test_collective_stage1_off_both_scales_predictor_matches_jax(neither):
    check_stage1_predictor(neither)


def test_collective_stage1_off_both_scales_train_step_matches_jax(neither):
    check_stage1_train_step(neither)
