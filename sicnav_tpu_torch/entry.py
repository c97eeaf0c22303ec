"""Entry points of the port (twin of the repository's
``__graft_entry__.py``): the flagship model's forward step, and the
multi-rank dry run.

    python -m sicnav_tpu_torch.entry [--device cpu] [--ranks N]

runs ``entry()``'s forward once (``entry ok``), then ``dryrun_multichip``
over N ranks, two by default (``dryrun ok``). Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): the forward step of the flagship model, the JMID
    joint diffusion predictor at ``ModelConfig(context_dim=128,
    tf_layer=2)`` (its parameters drawn with Flax's initializers from seed
    0). ``fn(model, batch)`` encodes each of the B = 4 scenes of ``batch``
    and runs one denoiser evaluation per scene (zero input, beta 0.05),
    returning (B, A, 8, 2). The scenes are the reference's, built from
    ``default_rng(0)``. On ``device``, CUDA unless named."""
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig, init_parameters

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    A, T, B = 4, 30, 4
    examples = []
    for _ in range(B):
        p0 = rng.uniform(-3, 3, (A, 1, 2))
        v = rng.uniform(-1, 1, (A, 1, 2))
        pos = p0 + v * np.arange(T)[None, :, None] * 0.25
        examples += D.build_examples(pos, np.ones((A, T), bool), 0.25,
                                     history_len=6, horizon=8, stride=30)
    batch = D.stack_batches(examples[:B]).to_tensors(device)

    model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2), joint=True,
                      device=device)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()

    def fwd(model, batch):
        # one sample per scene: the denoiser's sample axis
        ctx = model.encode(batch)                              # (B, A, F)
        B, A = batch.agent_mask.shape
        x = torch.zeros((B, 1, A, 8, 2), device=ctx.device)
        beta = torch.full((B, 1, A), 0.05, device=ctx.device)
        return model.denoise(x, beta, ctx[:, None], batch)[:, 0]

    return fwd, (model, batch)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run ``parallel/dryrun.main`` (the env + DWA step, a JMID train step,
    a SARL DQN train step and a sharded fleet CAMPC solve on tiny shapes)
    in ``n_devices`` ranks on ``device`` (CUDA unless named: NCCL with a
    card per rank when there are enough, else gloo ranks sharing it).
    Returns rank 0's results; raises with the failing rank's traceback."""
    from sicnav_tpu_torch.parallel import dryrun
    from sicnav_tpu_torch.parallel.mesh import launch
    try:
        return launch(dryrun.main, n_devices, device=device)
    except RuntimeError as e:
        raise RuntimeError(f"multi-rank dryrun over {n_devices} ranks "
                           f"failed:\n{e}") from e


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args()
    fn, example = entry(args.device)
    out = fn(*example)
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("entry: non-finite output")
    print("entry ok", tuple(out.shape))
    res = dryrun_multichip(args.ranks, args.device)
    print("dryrun ok", res["mesh"])
