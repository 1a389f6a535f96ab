"""host_issue_ms.train_p95: ``host_issue_ms.train`` in a cell whose steps
the host paces, where it moves ``train_step_ms_p95``: the median over the
window's steps of the host clock from calling ``train_step`` to its
return (the step makes no host sync; the result's ``host_syncs_per_unit``)."""

from portbench.readers import median


def read(run):
    return median(run.window.host_issue_ms) if run.trace is not None else None
