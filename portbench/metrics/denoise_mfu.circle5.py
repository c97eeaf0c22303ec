"""Denoiser: its counted operations a batched step (the configuration's
shapes, ``flops.concat_linear_denoiser`` x the DDIM passes x the batch)
over (``denoise_ms`` x the float32 peak): the DDIM loop's share of its
roofline."""

from portbench.lib import peaks


def read(data):
    ms, work = data.get("denoise_ms"), data.get("denoise_flops")
    if not ms or not work:
        return None
    return 100.0 * work / (ms / 1e3 * peaks.FP32_FLOPS)
