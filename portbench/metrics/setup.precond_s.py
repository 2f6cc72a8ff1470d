"""Host set-up of the preconditioner (``IcPreconditioner``): host seconds
of its construction, ending in a synchronise."""


def read(run):
    return run.setup_times.get("precond_s")
