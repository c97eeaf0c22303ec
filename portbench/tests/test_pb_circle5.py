"""The circle-crossing cell of JMID at its published size
(``sicnav_diffusion_circle5_jmid256.eval_b10``): its files load by name,
it reports what ``BENCHMARK.json`` gives it, its readers report nothing
rather than 0 when they find nothing, its driver takes the DDIM loop's
time from the window's steps alone, and the cases it leaves out are
exactly those whose reset stalls."""

import time
import types

import numpy as np
import pytest
import torch

from portbench.lib import flops, port, registry
from portbench.lib.spans import Spans
from sicnav_tpu_torch.env import scenarios

BENCH = registry.benchmark()
CELL = "sicnav_diffusion_circle5_jmid256.eval_b10"
CONFIG = "sicnav_diffusion_circle5_jmid256"
LAYER = ["forecast_ms.circle5", "mpc_ms.circle5", "kde_roofline.circle5",
         "idle_share.circle5", "mfu.circle5", "denoise_ms.circle5",
         "denoise_mfu.circle5"]


def test_configuration_and_cell_load_by_name():
    cfg = registry.config(CONFIG)
    wl = registry.workload(CELL)
    entry = {c["name"]: c for c in BENCH["configs"]}[CONFIG]
    assert entry["source"] == cfg["source"] and entry["why"] == cfg["why"]
    assert entry["reduced"] == cfg["reduced"] == []
    assert entry["source"] not in {c["source"] for c in BENCH["configs"]
                                   if c["name"] != CONFIG}
    assert cfg["model"]["widths"] == {"context_dim": 256, "tf_layer": 3}
    assert cfg["model"]["weights"] == "weights/jmid_mc_man_nod.npz"
    assert cfg["forecaster"] == {"num_samples": 100, "num_ret_samples": 10,
                                 "ddim_stride": 2}
    assert wl["config"] == CONFIG and wl["batch"] == 10 and wl["ipm"] == 30
    assert hasattr(registry.driver(wl["driver"]), "run")
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["config"] == CONFIG


def test_cell_reports_its_metrics():
    e2e, layer = registry.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"episode_steps_per_s", "setup_s"}
    assert sorted(m["name"] for m in layer) == sorted(LAYER)
    for m in layer:
        assert m["moves"] == "episode_steps_per_s"
        assert m["workloads"] == [CELL]


@pytest.mark.parametrize("name", LAYER)
@pytest.mark.parametrize("data", [{}, {"spans": Spans(False)},
                                  {"step_ms": 0.0, "denoise_ms": None}])
def test_reader_finds_nothing(name, data):
    assert registry.metric_reader(name).read(dict(data)) is None


def test_denoise_flops_are_the_step_counts_denoiser():
    """The denoiser's count is the denoiser term of the whole step's count
    (99.9 % of it at these shapes)."""
    ns = port.namespace("port")
    cfg = registry.config(CONFIG)
    drv = registry.driver("eval_loop_denoise")
    den = drv.denoise_flops(ns, cfg, 10)
    step = flops.control_step(10, 5, 6, 8, 100, 50, 256, 128, 3,
                              cfg["mpc"]["kkt_dim"], 30)
    assert den == 10 * 50 * flops.concat_linear_denoiser(100, 40, 5, 256,
                                                         128, 3)
    assert 0.998 < den / step < 1.0


def _stub_eval_loop(sample):
    """An ``eval_loop`` that calls ``sample`` as the real one does: once in
    the set-up, once a step of the window, once in the profiled step."""
    def run(ctx):
        spans = Spans(True, torch.device("cpu"))
        sample(None, 0.2)
        t_window = time.perf_counter()
        for _ in range(3):
            with spans.span("step"):
                sample(None, 0.01)
        spans.keep_times = False
        sample(None, 0.2)
        return {"t_window_start": t_window, "layer": {"spans": spans}}
    return types.SimpleNamespace(run=run, _cases=None)


def test_denoise_ms_reads_the_window_alone(monkeypatch):
    ns = port.namespace("port")
    monkeypatch.setattr(ns.mid.JMIDModel, "sample",
                        lambda self, secs: time.sleep(secs))
    stub = _stub_eval_loop(lambda *a: ns.mid.JMIDModel.sample(*a))
    drv = registry.driver("eval_loop_denoise")
    real = registry.driver
    monkeypatch.setattr(registry, "driver",
                        lambda name: stub if name == "eval_loop"
                        else real(name))
    ctx = types.SimpleNamespace(
        trace=True, program="port", device=torch.device("cpu"),
        workload=registry.workload(CELL), config=registry.config(CONFIG),
        size=lambda key, default: default)
    out = drv.run(ctx)
    assert 10.0 <= out["layer"]["denoise_ms"] < 60.0
    assert out["layer"]["denoise_flops"] == drv.denoise_flops(
        ns, ctx.config, 10)
    mfu = registry.metric_reader("denoise_mfu.circle5").read(out["layer"])
    assert mfu == pytest.approx(100.0 * out["layer"]["denoise_flops"] / (
        out["layer"]["denoise_ms"] / 1e3 * 67e12))


def test_stalled_resets_are_the_cases_whose_placement_stalls(monkeypatch):
    """Of the protocol's cases 0-499 at this configuration, the placement
    loop of ``generate_host`` draws on past a million numbers on exactly
    the workload's ``stalled_resets`` (the case that needs the most of the
    others, 442, takes 257,577; the cap is a count, not a time, so a loaded
    host reads the same), and the cell's draw never yields one."""
    ns = port.namespace("port")
    cfg = ns.env_types.EnvConfig(**registry.config(CONFIG)["env"])
    wl = registry.workload(CELL)
    real = np.random.default_rng

    class Stuck(Exception):
        pass

    class Capped:
        """The scenario's generator, stopped after ``cap`` draws."""

        def __init__(self, seed, cap=10 ** 6):
            self.gen, self.left = real(seed), cap

        def random(self, *args, **kwargs):
            self.left -= 1
            if self.left < 0:
                raise Stuck()
            return self.gen.random(*args, **kwargs)

        def __getattr__(self, name):
            return getattr(self.gen, name)

    monkeypatch.setattr(np.random, "default_rng", Capped)
    stuck = []
    for case in range(*wl["cases"]):
        try:
            scenarios.generate_host(cfg, case)
        except Stuck:
            stuck.append(case)
    monkeypatch.undo()
    assert stuck == wl["stalled_resets"]

    drv = registry.driver("eval_loop_denoise")
    drawn = set()

    def run(ctx):
        rng = np.random.default_rng(2 ** 31 + 11)
        for _ in range(60):
            drawn.update(mod._cases(rng, wl, 10))

    mod = types.SimpleNamespace(run=run, _cases=None)
    monkeypatch.setattr(registry, "driver", lambda name: mod)
    drv.run(types.SimpleNamespace(trace=False, workload=wl))
    assert mod._cases is None
    assert drawn and not drawn & set(wl["stalled_resets"])
