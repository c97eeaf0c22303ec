"""Env step (env/crowd_sim.step_masked): milliseconds a batched step, from
spans that end in a device sync."""

from portbench.lib import layer


def read(data):
    return layer.span_ms(data, "env_step", "step")
