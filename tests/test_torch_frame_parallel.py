"""Frame parallelism (``cfg.frame_parallel``) on a 2x2 world of gloo ranks
(``mesh_shape={"data": 2, "model": 2}``), on the CPU, at
tests/test_parallel.py's ``_setup()`` geometry (tests/test_torch_ddp.py)
with ``frame_chunk=8``: each data group holds 4 clips (8 frames), each
rank of its model group 4 of those frames through the backbone and
RoIAlign; each 8-frame chunk spans the two ranks of a model group, its
BatchNorm statistics reduced over them; the RoI features are gathered over
the model group for the head; the gradients summed over the 4 ranks and
halved (both ranks of a model group compute their group's loss).

- against din_tpu's chunked single-device step (test_parallel.py
  ``test_frame_parallel_matches_single_device``'s reference, at its
  tolerances): the loss, the parameters, and the running statistics,
  equal on every rank;
- against the port's single-process step at ``frame_chunk=8`` with the
  backbone in float64: the loss within rtol 1e-6 and the gradients within
  1e-5 of the largest |g|, on every rank.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_ddp import (assert_grads_close, assert_like_jax, batch_of,
                            chunked, jax_init, jax_steps, joined, launch,
                            port_cfg, port_state, run_case)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

MESH = {"mesh_shape": {"data": 2, "model": 2}, "frame_parallel": True,
        "frame_chunk": 8}


@pytest.fixture(scope="module")
def runs():
    batch = batch_of(port_cfg())
    state = port_state()
    cases = [dict(name="fp", cfg=MESH, batch=batch, state=state),
             dict(name="fp_exact", cfg=MESH, batch=batch, state=state,
                  exact=True, grads=True)]
    ranks = launch(4, cases)
    with ThreadPoolExecutor(1) as pool:     # beside din_tpu's step
        single = pool.submit(run_case, dict(
            name="single", cfg={"frame_chunk": 8}, batch=batch, state=state,
            exact=True, grads=True))
        want = jax_steps(chunked(jax_init({}, batch, state), 8), batch)
        single = single.result()
    return {"ranks": joined(ranks), "single": single, "jax": want}


def test_frame_parallel_matches_din_tpu(runs):
    # each data group's loss is computed by both ranks of its model group
    ranks = [r for i, r in enumerate(runs["ranks"]) if i % 2 == 0]
    assert_like_jax(ranks, *runs["jax"], "fp")
    for r in runs["ranks"]:
        for k, v in r["fp"]["state"].items():
            assert torch.equal(v, runs["ranks"][0]["fp"]["state"][k]), k


def test_frame_parallel_matches_one_process(runs):
    ranks, single = runs["ranks"], runs["single"]
    for pair in ((0, 1), (2, 3)):
        a, b = (ranks[i]["fp_exact"]["loss"] for i in pair)
        assert a == b                       # one data group, one loss
    np.testing.assert_allclose(
        ranks[0]["fp_exact"]["loss"][0] + ranks[2]["fp_exact"]["loss"][0],
        single["loss"][0], rtol=1e-6)
    for i, r in enumerate(ranks):
        assert_grads_close(r["fp_exact"]["grads"], single["grads"],
                           f"rank {i}")
