"""samples_per_s.train_p95: ``train_samples_per_s`` as a per-layer reading
in a cell whose steps the host paces (there its runs spread too widely to
hold it end to end): training rows of every step the untraced window
issued, over the window's seconds to the completion of its last step
(host clock). Read in the traced run."""


def read(run):
    w = run.window
    return w.items / w.seconds if run.trace is not None and w.units else None
