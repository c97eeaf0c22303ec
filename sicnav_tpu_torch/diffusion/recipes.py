"""Training recipes (twin of ``sicnav_tpu/diffusion/recipes.py``): the
reference's named configurations as presets of the port's ``TrainConfig``
and ``ModelConfig``.

Per-dataset iMID (``ddim_p3_bs256_lr001_{eth,hotel,univ,zara1,zara2}``
and two JRDB BEV frame rates) and JMID
(``ddim_jp_p3_bs64_lr0001_{eth,hotel,univ,zara1,zara2}``), plus the
simulator recipe ``ddim_jp_sim``. Each entry fixes the model size, the
optimizer budget, the dataset's frame period (dt) and the sequence shape
(history and prediction horizon).
"""

from __future__ import annotations

import dataclasses

from sicnav_tpu_torch.diffusion.mid import TrainConfig
from sicnav_tpu_torch.diffusion.models import ModelConfig


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    joint: bool                 # JMID (joint) vs iMID (independent)
    dataset: str                # eth/hotel/univ/zara1/zara2/jrdb/sim
    dt: float                   # source frame period after resampling
    history_len: int            # frames of history incl. current
    horizon: int                # prediction steps
    train: TrainConfig = None
    model: ModelConfig = None


def _imid(dataset, dt=0.4, epochs=900):
    # iMID: encoder 256, 3 transformer layers, batch 256, lr 1e-3,
    # horizon 12, history 7
    return Recipe(
        name=f"ddim_p3_bs256_lr001_{dataset}", joint=False, dataset=dataset,
        dt=dt, history_len=7, horizon=12,
        train=TrainConfig(joint=False, lr=1e-3, epochs=epochs,
                          batch_size=256),
        model=ModelConfig(context_dim=256, tf_layer=3, history_len=7,
                          horizon=12))


def _jmid(dataset, dt=0.4):
    # JMID: batch 64, lr 1e-4, 500 epochs
    return Recipe(
        name=f"ddim_jp_p3_bs64_lr0001_{dataset}", joint=True,
        dataset=dataset, dt=dt, history_len=7, horizon=12,
        train=TrainConfig(joint=True, lr=1e-4, epochs=500, batch_size=64),
        model=ModelConfig(context_dim=256, tf_layer=3, history_len=7,
                          horizon=12))


RECIPES = {r.name: r for r in [
    # iMID ETH/UCY, 900 epochs
    _imid("eth"), _imid("hotel"), _imid("univ"),
    _imid("zara1"), _imid("zara2"),
    # iMID JRDB BEV at two frame rates, 450 epochs
    dataclasses.replace(_imid("jrdb", dt=0.25, epochs=450),
                        name="ddim_p3_bs256_lr001_jrdb_bev_0_25_multi_class_clean"),
    dataclasses.replace(_imid("jrdb", dt=0.4, epochs=450),
                        name="ddim_p3_bs256_lr001_jrdb_bev_0_4_multi_class_clean"),
    # JMID ETH/UCY, 500 epochs
    _jmid("eth"), _jmid("hotel"), _jmid("univ"),
    _jmid("zara1"), _jmid("zara2"),
    # the simulator recipe: encoder 256, 3 layers, 90 epochs, history 6,
    # horizon 8 at dt 0.25
    Recipe(name="ddim_jp_sim", joint=True, dataset="sim", dt=0.25,
           history_len=6, horizon=8,
           train=TrainConfig(joint=True, lr=1e-4, epochs=90, batch_size=8),
           model=ModelConfig(context_dim=256, tf_layer=3, history_len=6,
                             horizon=8)),
]}


def get_recipe(name: str) -> Recipe:
    if name not in RECIPES:
        raise KeyError(f"unknown recipe {name!r}; available: "
                       f"{sorted(RECIPES)}")
    return RECIPES[name]
