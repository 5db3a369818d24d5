"""ARG and GCNNet (Volleyball and Collective Activity) against the JAX
package's, on the CPU, with the geometry, weights, helpers and tolerances
of tests/test_torch_baselines.py: eval posteriors of a 9-frame clip scored
as three 3-frame crops (GCNNetCollective: 13 and 5 actors, its action
mask), and each baseline preset built at its full width.
"""

import pytest

from din_tpu_torch.experiments.presets import PRESETS
from din_tpu_torch.models.registry import build_model
from test_torch_baselines import check_eval, setup
from test_torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["arg", "gcnnet_volleyball",
                                  "gcnnet_collective"])
def test_eval_posteriors_match_jax(name):
    check_eval(setup(name, unsaturate=True))


@pytest.mark.parametrize("name", ["pctdm_volleyball", "higcin_volleyball",
                                  "at_volleyball", "arg_volleyball",
                                  "sacrf_biute_volleyball"])
def test_presets_build_at_full_width(name):
    """Each baseline preset builds at its full width and geometry: ResNet-18
    on 720x1280 frames (a 23x40 map, as the presets' out_size), 12 actors,
    NFB 1024; HiGCIN on 7x7 crops of the raw 512 channels; ARG with 3
    training frames, a frozen backbone and 16 graphs of NFR 256."""
    preset = "volleyball_stage2_" + name.rsplit("_", 1)[0]
    cfg = PRESETS[preset]().replace(load_backbone_stage2=False)
    assert cfg.inference_module_name == name
    assert (cfg.backbone, cfg.image_size, cfg.out_size) == (
        "res18", (720, 1280), (23, 40))
    model = build_model(cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    if name == "higcin_volleyball":
        assert cfg.crop_size == (7, 7) and not hasattr(model, "fc_emb_1")
        assert tuple(model.BIM.theta.weight.shape) == (256, 512)
    else:
        assert tuple(model.fc_emb_1.weight.shape) == (1024, 512 * 25)
    if name == "arg_volleyball":
        assert not cfg.train_backbone and cfg.num_frames == 3
        assert not any(p.requires_grad for p in model.backbone.parameters())
        assert len(model.gcn_list[0].fc_rn_theta_list) == 16
        assert tuple(model.gcn_list[0].nl_gcn_list[0].weight.shape) == (
            36, 1024)
    if name == "pctdm_volleyball":
        assert tuple(model.pctdm_nl.weight.shape) == (10, 2000)
    assert n > 11e6      # ResNet-18's 11.2M and the head
