"""Controller (mpc/sicnav_diffusion.act_on_forecasts_batch -> campc ->
ipm.solve): milliseconds a batched step of the circle-crossing cell, from
spans."""

from portbench.lib import layer


def read(data):
    return layer.span_ms(data, "mpc", "step")
