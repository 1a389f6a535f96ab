"""host_issue_ms.predict: the median over the window's batches of the host
clock from calling the sampler's ``sample`` to its return: the host's
enqueue of a batch's launches. The sampler makes no host sync (set-up
counts the syncs of one batch under CUDA's sync debug mode and prints the
count in the result's ``host_syncs_per_unit``)."""

from portbench.readers import median


def read(run):
    return median(run.window.host_issue_ms) if run.trace is not None else None
