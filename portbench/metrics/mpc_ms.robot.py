"""Controller (mpc/sicnav_diffusion.act_on_forecasts -> campc_action):
milliseconds a tick, from spans."""

from portbench.lib import layer


def read(data):
    return layer.span_ms(data, "mpc", "tick")
