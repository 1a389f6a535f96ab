"""host_issue_ms.train: the median over the window's steps of the host
clock from calling ``train_step`` to its return: the host's enqueue of a
step's launches. The step makes no host sync (set-up counts the syncs of
one step under CUDA's sync debug mode and prints the count in the
result's ``host_syncs_per_unit``)."""

from portbench.readers import median


def read(run):
    return median(run.window.host_issue_ms) if run.trace is not None else None
