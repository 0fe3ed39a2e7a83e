"""Config A of OBJECTS.md over its 300 frames: the port's
run_object_mapping against the JAX package's, float64 on the CPU.

Marked slow (some 5 min: the JAX package's run takes some 3 of them):
it is the whole world at full length, where the fast files hold every
module and a 24-frame run of the slice. The two packages' generators
differ by some 2.5e-8 in the IMU samples (closed form against finite
differences, orcvio_tpu_torch/dataio/synthetic.py), so the figures are
held as chip_smoke.py's phase 12 holds the card's: objects matched and
estimated and updates applied equal, mean IoU within 0.02, ATE within
5 mm.
"""
import pytest
import torch

from orcvio_tpu.eval.object_map_sim import WorldConfig as JaxWorldConfig
from orcvio_tpu.eval.object_map_sim import run_object_mapping as jax_run
from orcvio_tpu_torch.eval.object_map_sim import (WorldConfig,
                                                  run_object_mapping)

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("use_update", [True, False])
def test_config_a_figures(use_update):
    torch.set_num_threads(4)
    j = jax_run(JaxWorldConfig(), use_object_update=use_update,
                collect_diag=True)
    p = run_object_mapping(WorldConfig(), use_object_update=use_update,
                           dtype=torch.float64, device="cpu",
                           collect_diag=True)
    for k in ("n_matched", "n_est", "n_gt"):
        assert p[k] == j[k], k
    assert sum(d["used"] for d in p["diag"]) == \
        sum(d["used"] for d in j["diag"])
    assert abs(p["mean_iou"] - j["mean_iou"]) <= 0.02
    assert abs(p["ate_m"] - j["ate_m"]) <= 0.005
