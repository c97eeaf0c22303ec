"""Operations and bytes counted from shapes, independent of how the port
computes them, so no change to the program can push a share of a peak
over 100 %. Each count is a floor: a multiply-add is 2 operations, an
exponential 1; elementwise work outside the named products is left out.
"""

from __future__ import annotations


def linear(rows, d_in, d_out):
    return 2 * rows * d_in * d_out


def lstm(n_seq, T, d_in, hidden):
    """An LSTM over n_seq sequences of T frames: the input and the
    recurrent projections to the four gates."""
    return n_seq * T * (linear(1, d_in, 4 * hidden) +
                        linear(1, hidden, 4 * hidden))


def trajectron_encoder(n_agents, T, state_dim, hidden):
    """The history LSTM, the edge LSTM (neighbours summed, concatenated to
    the history) and the additive attention over one edge key."""
    return (lstm(n_agents, T, state_dim, hidden) +
            lstm(n_agents, T, 2 * state_dim, hidden) +
            n_agents * (2 * linear(1, hidden, hidden) + linear(1, hidden, 1)))


def transformer_layer(n_seq, tokens, d, d_ff):
    """Q, K, V and the output projection, the scores and the weighted sum,
    the feed-forward pair, for n_seq sequences of ``tokens`` tokens."""
    per = (4 * linear(tokens, d, d) + 2 * 2 * tokens * tokens * d +
           linear(tokens, d, d_ff) + linear(tokens, d_ff, d))
    return n_seq * per


def concat_squash(n_seq, tokens, d_in, ctx, d_out):
    """W x per token; the gate and the bias from one context row."""
    return n_seq * (linear(tokens, d_in, d_out) + 2 * linear(1, ctx, d_out))


def concat_linear_denoiser(n_seq, tokens, n_ctx, context_dim, enc_rnn_dim,
                           tf_layer, pred_dim=2):
    """(Joint)TransformerConcatLinear: n_seq sequences of ``tokens`` tokens
    that carry ``n_ctx`` context rows each (1 for iMID's agent sequences,
    A for JMID's scenes of A agents)."""
    d = 2 * context_dim
    ctx = 3 + 2 * enc_rnn_dim
    c = context_dim
    per_ctx = n_seq * n_ctx

    def cs(d_in, d_out):
        return (linear(n_seq * tokens, d_in, d_out) +
                2 * linear(per_ctx, ctx, d_out))

    return (cs(pred_dim, d) +
            transformer_layer(n_seq, tokens, d, 4 * c) * tf_layer +
            cs(d, c) + cs(c, c // 2) + cs(c // 2, pred_dim))


def kde_flops(G, S, D):
    """The pair terms of G groups of S samples of width D: per pair D
    differences, D squares, D - 1 sums, the scale and the normalizer, the
    exponential and the sum of the logsumexp: 3 D + 4."""
    return G * S * S * (3 * D + 4)


def kde_bytes(G, S, D):
    """Each input read once and each output written once, float32: the
    whitened samples (G, S, D), the normalizers (G,), the result (G, S)."""
    return 4 * (G * S * D + G + G * S)


def lu(n):
    """A dense LU factorisation of an n x n matrix."""
    return 2 * n ** 3 // 3


def lu_solve(n):
    """The two triangular solves of one right-hand side."""
    return 2 * n * n


def control_step(batch, humans, hist_len, horizon, samples, nfe,
                 context_dim, enc_rnn_dim, tf_layer, kkt_dim, ipm_iters):
    """A floor of the work of one SICNav-Diffusion control step of
    ``batch`` episodes: the JMID encoder once, the joint denoiser for
    ``nfe`` DDIM passes over ``samples`` scenes, the KDE pair terms of the
    joint ranking (one group per horizon step, D = 2 x humans), and per IPM
    iteration the factorisation of the KKT matrix and its solve."""
    enc = trajectron_encoder(humans, hist_len, 6, enc_rnn_dim)
    den = concat_linear_denoiser(samples, humans * horizon, humans,
                                 context_dim, enc_rnn_dim, tf_layer)
    kde = kde_flops(horizon, samples, 2 * humans)
    ipm = ipm_iters * (lu(kkt_dim) + lu_solve(kkt_dim))
    return batch * (enc + nfe * den + kde + ipm)

