"""train_samples_per_s: training rows of every step the window issued,
over the window's seconds, from its start to the completion of its last
step (host clock)."""


def read(run):
    w = run.window
    return w.items / w.seconds if w.units else None
