"""A CPU rehearsal of ``chip_smoke.py``'s imid phase at small widths, as
``tests/test_torch_train_scripts.py`` rehearses its train phase: the
synthesizer's ETH-format files, a small iMID checkpoint served through
``eval_prediction_torch.py --method mid --full``, and one epoch of the ETH
iMID recipe (at small widths) through ``train_jmid_torch.py --recipe``.
The CUDA-only checks (the kernel's launches and plain version, card vs
CPU, the profile, the sync count) run on the card."""

import os
import sys

import torch

from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.diffusion import recipes as R
from sicnav_tpu_torch.ops import kde_cuda as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

torch.set_num_threads(2)


def test_chip_smoke_imid_rehearsal(tmp_path):
    import chip_smoke
    widths = dict(context_dim=16, tf_layer=1)
    model = MID.JMIDModel(M.ModelConfig(**widths), joint=False, device="cpu")
    M.init_parameters(model, torch.Generator().manual_seed(0))
    weights = str(tmp_path / "imid_small.npz")
    convert.save_npz(weights, model.state_dict())
    recipe = R.get_recipe(chip_smoke.IMID_RECIPE)
    launches = chip_smoke.phase_imid(
        K, device="cpu", weights=weights, widths=widths, n_rollouts=4,
        max_serve=3,
        recipe_model=M.ModelConfig(context_dim=16, tf_layer=1,
                                   history_len=7, horizon=12),
        out_dir=str(tmp_path))
    assert launches == 0           # CPU tensors take the plain version
    assert R.get_recipe(chip_smoke.IMID_RECIPE) is recipe   # restored
    sd = convert.load_npz(str(tmp_path / "imid_recipe.npz"))
    assert "denoiser.concat1.layer.weight" in sd
    assert os.listdir(tmp_path / "eth" / "train")
