"""Denoiser (diffusion/mid.JMIDModel.sample: the encoder, the DDIM passes
and the integration): milliseconds a batched step, from a span that ends in
a device sync (``drivers/eval_loop_denoise``)."""


def read(data):
    return data.get("denoise_ms")
