"""Process start to the window's first poll: imports, library loads and
builds, the event pool, the warm job, and the measured job's own set-up."""


def read(run):
    return run.setup_s
