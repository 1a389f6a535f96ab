"""optimizer_ms.train: device ms a step of everything launched inside
``train/state.py`` ``AdamW.step`` and ``ema_update`` (as the train step
calls them), in the traced window."""

from portbench.readers import ranges_time_ms_per_unit

SPANS = {"adamw": "osu_dreamer_tpu_torch.train.state:AdamW.step",
         "ema": "osu_dreamer_tpu_torch.models.diffusion.train:ema_update"}


def read(run):
    return ranges_time_ms_per_unit(run, SPANS)
