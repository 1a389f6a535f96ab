"""optimizer_ms.train_p95: ``optimizer_ms.train`` in a cell whose steps the
host paces, where it moves ``train_step_ms_p95``: device ms a step of
everything launched inside ``AdamW.step`` and ``ema_update``."""

from portbench.readers import ranges_time_ms_per_unit

SPANS = {"adamw": "osu_dreamer_tpu_torch.train.state:AdamW.step",
         "ema": "osu_dreamer_tpu_torch.models.diffusion.train:ema_update"}


def read(run):
    return ranges_time_ms_per_unit(run, SPANS)
