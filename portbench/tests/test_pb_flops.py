"""The work counters against hand counts and against torch's own count
of the matrix products of the frozen reference's modules."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import flops
from portbench.reference.frozen.diffusion import models as M


def test_hand_counts():
    assert flops.linear(3, 4, 5) == 2 * 3 * 4 * 5
    assert flops.lstm(2, 3, 4, 5) == 2 * 3 * (2 * 4 * 20 + 2 * 5 * 20)
    assert flops.lu(3) == 18
    assert flops.lu_solve(317) == 2 * 317 * 317
    # (80, 48, 6): 80 x 48 x 48 pairs of 3 x 6 + 4 operations; float32
    # samples, normalizers and outputs read or written once
    assert flops.kde_flops(80, 48, 6) == 80 * 48 * 48 * 22
    assert flops.kde_bytes(80, 48, 6) == 4 * (80 * 48 * 6 + 80 + 80 * 48)
    # one transformer layer of 1 sequence of 2 tokens, d 4, d_ff 8
    assert flops.transformer_layer(1, 2, 4, 8) == \
        4 * 2 * 2 * 4 * 4 + 4 * 2 * 2 * 4 + 2 * 2 * 4 * 8 * 2


CFG = M.ModelConfig(context_dim=16, enc_rnn_dim=8, tf_layer=2, n_heads=2,
                    history_len=5, horizon=6, dropout=0.0)


def _counted(module, *args):
    with FlopCounterMode(display=False) as fc:
        module(*args)
    return fc.get_total_flops()


def test_imid_denoiser_matches_torch_count():
    n = 7
    den = M.TransformerConcatLinear(CFG)
    got = _counted(den, torch.randn(n, 6, 2), torch.rand(n),
                   torch.randn(n, 16))
    assert got == flops.concat_linear_denoiser(n, 6, 1, 16, 8, 2)


def test_jmid_denoiser_matches_torch_count():
    S, A = 4, 3
    den = M.JointTransformerConcatLinear(CFG)
    mask = torch.ones(A * 6, A * 6, dtype=torch.bool)
    got = _counted(den, torch.randn(S, A, 6, 2), torch.rand(S, A),
                   torch.randn(S, A, 16), mask)
    assert got == flops.concat_linear_denoiser(S, A * 6, A, 16, 8, 2)


def test_encoder_matches_torch_count():
    n = 7
    enc = M.TrajectronEncoder(CFG)
    got = _counted(enc, torch.randn(n, 5, 6),
                   torch.ones(n, 5, dtype=torch.bool),
                   torch.randn(n, 4, 5, 6), torch.ones(n, 4, dtype=torch.bool))
    assert got == flops.trajectron_encoder(n, 5, 6, 8)

