"""Interactive knob-slider demo (the port of demo/bokeh_sliders.py).

    bokeh serve signaltrain_tpu_torch/cli/bokeh_sliders.py

(needs bokeh, which neither the development machine nor the card's has;
``cli/knob_sweep.py`` is the headless counterpart). An effect dropdown picks
a checkpoint (comp_4c or denoise, from ``demo/`` unless ``ST_DEMO_COMP4C`` /
``ST_DEMO_DENOISE`` name others), an input dropdown a synthesized test
signal, and each knob's slider re-runs both the true effect and the model on
every change, plotting input, target and prediction.

``DemoState`` is what a slider's callback runs (reference
bokeh_sliders.py:167-201): the checkpoint loaded on ``device`` (the card
unless ``device="cpu"``), the input synthesized from its own generator
(seeded 0), the knobs in world coordinates normalized, the effect (kernel C
for comp_4c on the card) and the model's fused forward (kernels A and B).
bokeh is imported only by ``main_bokeh``, which ``bokeh serve`` runs.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

if not __package__:  # run as a script by ``bokeh serve``: the package is two levels up
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

DEMO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "demo")
# checkpoint files per effect (the reference keeps these in demo/)
EFFECT_CHECKPOINTS = {
    "comp_4c": os.environ.get("ST_DEMO_COMP4C", "model_comp4c_4k.tar"),
    "denoise": os.environ.get("ST_DEMO_DENOISE", "modelcheckpoint_denoise.tar"),
}
SIGNAL_CHOICES = {
    "sine": 0, "noisy sine": 1, "pluck": 2, "triangle": 3, "box": 4,
    "spikes": 5, "noisy box": 6, "noisy pluck": 7, "amp steps": 8, "sweep": 9,
}


class DemoState:
    def __init__(self, effect_name: str, device: str | torch.device = "cuda"):
        from signaltrain_tpu_torch.dsp import effects as fx
        from signaltrain_tpu_torch.utils.load_model import load_model

        ckpt = EFFECT_CHECKPOINTS[effect_name]
        if not os.path.isabs(ckpt):  # relative names live in demo/
            here = os.path.join(DEMO_DIR, ckpt)
            ckpt = here if os.path.exists(here) else ckpt
        self.model, self.rv = load_model(ckpt, device=device)
        self.device = self.model.device
        self.effect_name = effect_name
        self.effect = fx.make_effect(effect_name, device=self.device)
        self.chunk = self.model.spec.in_chunk_size
        self.out_chunk = self.model.spec.out_chunk_size
        self.t = torch.arange(self.chunk, dtype=torch.float32,
                              device=self.device) / self.model.spec.sr
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.new_input("sine")

    def new_input(self, signal_name: str) -> None:
        from signaltrain_tpu_torch.dsp import synths

        self.x = synths.synth_input_sample(self.generator, self.t, SIGNAL_CHOICES[signal_name])[0]

    def run(self, knobs_wc):
        """(input, target, prediction) as numpy for knobs in world coordinates."""
        wc = torch.as_tensor(np.asarray(knobs_wc, np.float32), device=self.device)
        kr = self.effect.knob_ranges_on(self.device)
        knobs_nn = (wc - kr[:, 0]) / (kr[:, 1] - kr[:, 0]) - 0.5
        with torch.no_grad():
            y_target, x_in = self.effect.go_wc(self.x, wc, generator=self.generator)
            y_pred = self.model(x_in[None], knobs_nn[None])[0][0]
        return x_in.cpu().numpy(), y_target.cpu().numpy(), y_pred.cpu().numpy()


def main_bokeh(device: str = "cuda") -> None:
    from bokeh.io import curdoc
    from bokeh.layouts import column, row
    from bokeh.models import ColumnDataSource, Select, Slider
    from bokeh.plotting import figure

    state = DemoState("comp_4c", device)

    src_in = ColumnDataSource(data=dict(x=[], y=[]))
    src_tg = ColumnDataSource(data=dict(x=[], y=[]))
    src_pr = ColumnDataSource(data=dict(x=[], y=[]))
    fig = figure(height=420, width=900, y_range=(-1, 1), title="signaltrain-tpu-torch demo")
    fig.line("x", "y", source=src_in, color="blue", legend_label="Input")
    fig.line("x", "y", source=src_tg, color="red", legend_label="Target")
    fig.line("x", "y", source=src_pr, color="green", legend_label="Predicted")

    sliders = []

    def update_data(attr=None, old=None, new=None):
        x, y_t, y_p = state.run([s.value for s in sliders])
        n = len(x)
        src_in.data = dict(x=np.arange(n), y=x)
        src_tg.data = dict(x=np.arange(n), y=y_t)
        src_pr.data = dict(x=np.arange(n - len(y_p), n), y=y_p)

    def build_sliders():
        sliders.clear()
        for name, (lo, hi) in zip(state.effect.knob_names, state.effect.knob_ranges):
            s = Slider(start=float(lo), end=float(hi), value=float((lo + hi) / 2),
                       step=float((hi - lo) / 100), title=name)
            s.on_change("value", update_data)
            sliders.append(s)

    effect_select = Select(title="Effect", value="comp_4c", options=list(EFFECT_CHECKPOINTS))
    signal_select = Select(title="Input signal", value="sine", options=list(SIGNAL_CHOICES))

    def relayout():
        curdoc().clear()
        curdoc().add_root(column(row(effect_select, signal_select), column(*sliders), fig))

    def update_effect(attr, old, new):
        nonlocal state
        state = DemoState(new, device)
        build_sliders()
        relayout()
        update_data()

    def update_input(attr, old, new):
        state.new_input(new)
        update_data()

    effect_select.on_change("value", update_effect)
    signal_select.on_change("value", update_input)
    build_sliders()
    relayout()
    update_data()


if __name__.startswith("bokeh_app_"):  # the module name ``bokeh serve`` runs a script under
    main_bokeh(os.environ.get("ST_DEMO_DEVICE", "cuda"))
elif __name__ == "__main__":
    print("run this demo with `bokeh serve signaltrain_tpu_torch/cli/bokeh_sliders.py` (needs "
          "bokeh); python -m signaltrain_tpu_torch.cli.knob_sweep is the headless demo")
